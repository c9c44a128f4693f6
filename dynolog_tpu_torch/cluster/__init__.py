"""The cluster fan-out: one synchronized capture across every host of a
job (``unitrace``), over the daemon's framed RPC (``rpc``)."""
