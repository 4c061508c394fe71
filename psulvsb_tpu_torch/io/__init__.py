from psulvsb_tpu_torch.io.ply import read_ply, write_ply
