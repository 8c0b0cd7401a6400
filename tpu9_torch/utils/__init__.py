from .platform import default_device, device_kind, on_cuda

__all__ = ["default_device", "device_kind", "on_cuda"]
