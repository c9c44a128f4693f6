from dynolog_tpu_torch.client.ipc import IpcClient
from dynolog_tpu_torch.client.shim import (
    CaptureRing, RingConfig, TorchProfiler, TraceClient, TraceConfig)

__all__ = ["CaptureRing", "IpcClient", "RingConfig", "TorchProfiler",
           "TraceClient", "TraceConfig"]
