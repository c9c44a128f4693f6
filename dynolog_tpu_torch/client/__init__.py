from dynolog_tpu_torch.client.ipc import IpcClient
from dynolog_tpu_torch.client.shim import TorchProfiler, TraceClient, TraceConfig

__all__ = ["IpcClient", "TorchProfiler", "TraceClient", "TraceConfig"]
