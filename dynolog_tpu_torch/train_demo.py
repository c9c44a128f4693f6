"""End-to-end trace demo: the flagship transformer trained with AdamW under
the PyTorch shim, on the card by default.

Run next to a daemon, then trigger a trace:

    build/src/dynologd --enable_ipc_monitor &
    python -m dynolog_tpu_torch.train_demo --job-id 42 &
    build/src/dyno gputrace --job_id 42 --duration_ms 500 --log_file /tmp/t.json

Without a card it stops with an error; pass --device cpu to run on the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--job-id", type=int, default=0)
    parser.add_argument("--steps", type=int, default=0, help="0 = run forever")
    parser.add_argument("--endpoint", default="dynolog")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    from dynolog_tpu_torch import resolve_device
    from dynolog_tpu_torch.client import TraceClient
    from dynolog_tpu_torch.models.train import (
        make_batch, make_train_state, make_train_step)
    from dynolog_tpu_torch.models.transformer import TransformerConfig

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cfg = TransformerConfig(attn_impl="flash")
    params, optimizer = make_train_state(cfg, device, gen)
    step = make_train_step(cfg)
    batch = make_batch(gen, cfg, args.batch_size, args.seq_len, device)

    client = TraceClient(job_id=args.job_id, endpoint=args.endpoint)
    registered = client.start()
    print(f"device={device} daemon_registered={registered}", flush=True)

    i = 0
    try:
        while args.steps == 0 or i < args.steps:
            loss = step(params, optimizer, batch)
            client.step()
            i += 1
            if i % 50 == 0:
                print(f"step {i} loss {float(loss):.4f}", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        client.stop()
    print(f"done after {i} steps; traces captured: {client.traces_completed}")


if __name__ == "__main__":
    main()
