"""Multi-device execution of the port on ``torch.distributed``."""
