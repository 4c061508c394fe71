"""The seven examples of the JAX package's `examples/` folder on the port.

Each is a module run as `python -m psulvsb_tpu_torch.examples.<name>`, with
a `main(argv=None)` that parses `argv`, prints what the JAX example prints
and returns a small dict of it (errors, recall, counts), so that a caller
can check the result. Each takes `--device` (default "cuda"): without a
card the example exits non-zero, unless `--device cpu` asks for the host.
"""
