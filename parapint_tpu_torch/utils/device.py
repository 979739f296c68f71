"""Device selection for the port's entry points."""

import torch


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; "
            "pass device='cpu' to build on the CPU"
        )
    return device
