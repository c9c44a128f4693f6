"""On the card: the trace readers find the flash attention's and AdamW's
kernels under their host ops in a profile of the port's own calls."""

import pytest

from perfbench import traces


@pytest.mark.card
def test_op_instances_find_the_kernels(card, tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dynolog_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = (torch.randn(1, 256, 4, 128, device="cuda",
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    p = torch.nn.Parameter(torch.randn(1024, device="cuda",
                                       dtype=torch.bfloat16))
    opt = torch.optim.AdamW([p], fused=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        flash_attention(q, k, v).sum().backward()
        p.sum().backward()
        opt.step()
        torch.cuda.synchronize()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    events, _ = traces.load(path)
    assert len(traces.op_instances(events, traces.FLASH_FWD_OP,
                                   ("flash_fwd_kernel",))) == 1
    assert len(traces.op_instances(events, traces.FLASH_BWD_OP,
                                   ("flash_dq_kernel",
                                    "flash_dkv_kernel"))) == 1
    assert len(traces.op_instances(events, traces.ADAMW_OP)) == 1
