from dynolog_tpu_torch.client.ipc import IpcClient
from dynolog_tpu_torch.client.shim import (
    CaptureRing, RecordingProfiler, RingConfig, TorchProfiler, TraceClient,
    TraceConfig)

__all__ = ["CaptureRing", "IpcClient", "RecordingProfiler", "RingConfig",
           "TorchProfiler", "TraceClient", "TraceConfig"]
