from psulvsb_tpu_torch.certify.drs import CertificationResult, DRSCertifier, certify_rotation
