"""Front-end stages ahead of the solver: neighbours, normals and the
normal-angle pre-filter (counterparts of psulvsb_tpu/frontend/)."""
