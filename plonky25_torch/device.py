"""Device choice for the port's entry points.

Every entry point takes `device=` and defaults to "cuda".  Without a GPU it
raises unless the caller asked for the CPU: the port never moves to the CPU
on its own."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device, or raise if it cannot be used."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}: use 'cuda' or 'cpu'")
    return d
