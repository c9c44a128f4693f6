"""Causal flash attention: hand-written CUDA kernels for Hopper, forward and
backward, with a plain PyTorch version of each beside it.

The counterpart of ``dynolog_tpu/ops/flash_attention.py``, whose three
Pallas TPU programs become three CUDA kernels, each in two sources: for
bf16 on the tensor cores (``csrc/flash_fwd_sm90.cu``,
``csrc/flash_bwd_sm90.cu``), for f32 on the CUDA cores
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``):

- ``flash_fwd``: O = softmax(Q K^T / sqrt(D), causal) V by the online
  softmax, plus the per-row logsumexp (lse);
- ``flash_dq``: dQ, recomputing probabilities from lse;
- ``flash_dkv``: dK and dV together.

Dispatch: a wrapper takes its plain version only for tensors on the CPU
(the tests); for CUDA tensors it launches its kernel or raises. Each
launch adds one to ``launches[<kernel>]``, so a run can show that it went
through the kernels.

Block sizes: ``block_q``/``block_k`` set the schedule of the plain versions,
which mirror the Pallas kernels' blockwise recurrence (``_pick_block``
included). The CUDA kernels use fixed 64 x 64 tiles and mask the ragged
edge themselves, so every S works; both compute the same function, up to
the order of f32 sums. So the kernel wrappers take no block sizes, and
``flash_attention`` refuses other blocks than the default for CUDA
tensors. The default of 64 matches the CUDA tile; the reference's
512 x 512 was tuned on a TPU and is not carried over.

Rounding: the bf16 kernels run their products on the tensor cores, which
take bf16 operands, so P and dS enter the products that take them
(O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K) as a pair of bf16 each,
hi = bf16(x) and lo = bf16(x - hi) (16 significant bits), and the softmax
scale multiplies f32 accumulators. The forward kernel is held to the f32
``flash_forward_plain`` as it is; the plain backward versions carry P and
dS as the kernels do with ``round_like_kernel=True``, and by default keep
the JAX package's f32 numerics.
"""

from __future__ import annotations

import torch

from dynolog_tpu_torch.ops import _build

_NEG_INF = -1e30
DEFAULT_BLOCK = 64
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last reset_launches(), by kernel.
launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _pick_block(seq_len: int, target: int) -> int:
    """Largest divisor of seq_len that is <= target (>=1)."""
    b = min(target, seq_len)
    while seq_len % b:
        b -= 1
    return b


def reference_attention(q, k, v, *, causal: bool = True):
    """Plain attention; q,k,v: [B, S, H, D] -> [B, S, H, D]. Scores in the
    input dtype, then f32 for the mask and softmax, probabilities cast
    back, as the reference does."""
    d = q.shape[-1]
    scale = torch.tensor(float(d)).sqrt().to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
    scores = scores.float()
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _to_bh(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _from_bh(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def _delta(out, g):
    """rowsum(dO * O) in f32 as [B*H, S] (plain PyTorch, as the reference
    computes it in jnp outside its kernels)."""
    b, s, h, _ = out.shape
    delta = (g.float() * out.float()).sum(-1)  # [B, S, H]
    return delta.transpose(1, 2).reshape(b * h, s).contiguous()


def _scale(d: int):
    return torch.rsqrt(torch.tensor(float(d), dtype=torch.float32))


# ------------------------------------------------------- plain versions


def flash_forward_plain(q, k, v, causal=True, block_q=DEFAULT_BLOCK,
                        block_k=DEFAULT_BLOCK):
    """The forward kernel's function in plain PyTorch, block by block as the
    Pallas `_fwd_kernel` schedules it. q,k,v: [B, S, H, D] ->
    (out [B, S, H, D] in q's dtype, lse [B*H, S] f32)."""
    b, s, h, d = q.shape
    bq, bk = _pick_block(s, block_q), _pick_block(s, block_k)
    dev = q.device
    qs = _to_bh(q).float() * _scale(d).to(dev)
    kf, vf = _to_bh(k).float(), _to_bh(v).float()
    out = torch.empty_like(qs)
    lse = torch.empty(qs.shape[:2], dtype=torch.float32, device=dev)
    for qi in range(s // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        q_pos = torch.arange(qi * bq, (qi + 1) * bq, device=dev)
        m = torch.full(qs.shape[:1] + (bq,), _NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(qs.shape[0], bq, d, device=dev)
        n_kb = (qi * bq + bq + bk - 1) // bk if causal else s // bk
        for kb in range(n_kb):
            cols = slice(kb * bk, (kb + 1) * bk)
            sc = qs[:, rows] @ kf[:, cols].mT
            if causal:
                k_pos = torch.arange(kb * bk, (kb + 1) * bk, device=dev)
                sc = torch.where(q_pos[:, None] >= k_pos[None, :], sc,
                                 _NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf[:, cols]
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        out[:, rows] = acc / l_safe[..., None]
        lse[:, rows] = m + torch.log(l_safe)
    return _from_bh(out.to(q.dtype), b, h), lse


def _bwd_setup(q, k, v, g, lse, causal, block_q, block_k, round_like_kernel):
    """Shared by the two plain backward kernels: f32 [B*H, S, D] operands,
    the probabilities recomputed from lse, and the rounding of P and dS.

    By default Q is pre-scaled (the reference's numerics). For bf16 inputs
    with round_like_kernel, Q stays as it is, the scale multiplies the f32
    scores, and `rnd` carries P and dS as the tensor-core kernels do, as
    bf16(x) + bf16(x - bf16(x)); otherwise `rnd` is the identity."""
    s, d = q.shape[1], q.shape[3]
    bq, bk = _pick_block(s, block_q), _pick_block(s, block_k)
    dev = q.device
    scale = _scale(d).to(dev)
    rounding = round_like_kernel and q.dtype == torch.bfloat16
    qs = _to_bh(q).float() * (1.0 if rounding else scale)
    kf, vf, do = (_to_bh(x).float() for x in (k, v, g))

    def rnd(x):
        if not rounding:
            return x
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float()

    def probs(qb, kb):
        sc = qs[:, qb * bq:(qb + 1) * bq] @ kf[:, kb * bk:(kb + 1) * bk].mT
        if rounding:
            sc = sc * scale
        if causal:
            q_pos = torch.arange(qb * bq, (qb + 1) * bq, device=dev)
            k_pos = torch.arange(kb * bk, (kb + 1) * bk, device=dev)
            sc = torch.where(q_pos[:, None] >= k_pos[None, :], sc, _NEG_INF)
        return torch.exp(sc - lse[:, qb * bq:(qb + 1) * bq, None])

    return bq, bk, scale, qs, kf, vf, do, probs, rnd, rounding


def flash_dq_plain(q, k, v, g, lse, delta, causal=True,
                   block_q=DEFAULT_BLOCK, block_k=DEFAULT_BLOCK,
                   round_like_kernel=False):
    """The dQ kernel's function in plain PyTorch, scheduled as the Pallas
    `_dq_kernel`: per query block, over the key blocks up to its diagonal.
    [B, S, H, D] inputs, lse and delta [B*H, S] f32 -> dq. With
    round_like_kernel, bf16 inputs carry dS as the kernel does (a pair of
    bf16) and scale the scores, not Q."""
    b, s, h, d = q.shape
    bq, bk, scale, qs, kf, vf, do, probs, rnd, _ = _bwd_setup(
        q, k, v, g, lse, causal, block_q, block_k, round_like_kernel)
    dq = torch.empty_like(qs)
    for qb in range(s // bq):
        rows = slice(qb * bq, (qb + 1) * bq)
        acc = torch.zeros(qs.shape[0], bq, d, device=q.device)
        n_kb = (qb * bq + bq + bk - 1) // bk if causal else s // bk
        for kb in range(n_kb):
            cols = slice(kb * bk, (kb + 1) * bk)
            dp = do[:, rows] @ vf[:, cols].mT
            ds = probs(qb, kb) * (dp - delta[:, rows, None])
            acc = acc + rnd(ds) @ kf[:, cols]
        dq[:, rows] = acc * scale
    return _from_bh(dq.to(q.dtype), b, h)


def flash_dkv_plain(q, k, v, g, lse, delta, causal=True,
                    block_q=DEFAULT_BLOCK, block_k=DEFAULT_BLOCK,
                    round_like_kernel=False):
    """The dK/dV kernel's function in plain PyTorch, scheduled as the Pallas
    `_dkv_kernel`: per key block, over the query blocks from its diagonal
    down. [B, S, H, D] inputs, lse and delta [B*H, S] f32 -> (dk, dv).
    With round_like_kernel, bf16 inputs carry P and dS as the kernel does
    (a pair of bf16 each), scale the scores, and scale dK at the end."""
    b, s, h, d = q.shape
    bq, bk, scale, qs, kf, vf, do, probs, rnd, rounding = _bwd_setup(
        q, k, v, g, lse, causal, block_q, block_k, round_like_kernel)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for kb in range(s // bk):
        cols = slice(kb * bk, (kb + 1) * bk)
        acc_k = torch.zeros(qs.shape[0], bk, d, device=q.device)
        acc_v = torch.zeros_like(acc_k)
        for qb in range((kb * bk) // bq if causal else 0, s // bq):
            rows = slice(qb * bq, (qb + 1) * bq)
            p = probs(qb, kb)
            acc_v = acc_v + rnd(p).mT @ do[:, rows]
            dp = do[:, rows] @ vf[:, cols].mT
            ds = p * (dp - delta[:, rows, None])
            acc_k = acc_k + rnd(ds).mT @ qs[:, rows]
        dk[:, cols] = acc_k * scale if rounding else acc_k
        dv[:, cols] = acc_v
    return _from_bh(dk.to(k.dtype), b, h), _from_bh(dv.to(v.dtype), b, h)


def flash_backward_plain(q, k, v, out, lse, g, causal=True,
                         block_q=DEFAULT_BLOCK, block_k=DEFAULT_BLOCK,
                         round_like_kernel=False):
    """Both backward kernels' function in plain PyTorch: residuals
    (q, k, v, out, lse) and cotangent g -> (dq, dk, dv)."""
    delta = _delta(out, g)
    dq = flash_dq_plain(q, k, v, g, lse, delta, causal, block_q, block_k,
                        round_like_kernel)
    dk, dv = flash_dkv_plain(q, k, v, g, lse, delta, causal, block_q,
                             block_k, round_like_kernel)
    return dq, dk, dv


# ------------------------------------------------------- kernel wrappers


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors, False for CUDA ones; raises on anything else
    (mixed devices, other accelerators)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"flash attention takes CPU or CUDA tensors, got {kinds}")


def _check_cuda(*tensors) -> tuple[int, int, int, int]:
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"expected [B, S, H, D], got {tuple(q.shape)}")
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v (and dO, O) must share shape, dtype "
                             "and device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"CUDA flash kernels take f32 or bf16, not {q.dtype}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"CUDA flash kernels take head_dim in {HEAD_DIMS}, "
                         f"not {d}")
    return b, s, h, d


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned(x):
    """x contiguous, starting on a 16-byte boundary (the tensor maps of the
    bf16 kernels need it; a view into a larger tensor may start off it)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _lib(kernel: str, dtype) -> str:
    """The library of `kernel` for inputs of `dtype`: bf16 on the tensor
    cores (flash_*_sm90.cu), f32 on the CUDA cores."""
    return f"{kernel}_sm90" if dtype == torch.bfloat16 else kernel


def _launch_fwd(q, k, v, causal):
    """Checks the inputs and launches the forward kernel; returns (out,
    lse). The aligned inputs stay referenced here until the launch is
    enqueued."""
    b, s, h, d = _check_cuda(q, k, v)
    ins = [_aligned(x) for x in (q, k, v)]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    _build.call(_lib("flash_fwd", q.dtype), "flash_fwd",
                *(x.data_ptr() for x in ins + [out, lse]), b, h, s, d,
                int(causal), _DTYPE_CODES[q.dtype], _stream(q))
    launches["flash_fwd"] += 1
    return out, lse


def flash_forward(q, k, v, causal=True):
    """[B, S, H, D] -> (out [B, S, H, D], lse [B*H, S] f32)."""
    if _on_cpu(q, k, v):
        return flash_forward_plain(q, k, v, causal)
    return _launch_fwd(q, k, v, causal)


def _launch_bwd(fn, outs, q, k, v, g, lse, delta, causal) -> None:
    """Checks the inputs and launches backward kernel `fn` writing `outs`:
    bf16 on the tensor cores (flash_bwd_sm90.cu), f32 on the CUDA cores
    (flash_bwd.cu). The contiguous inputs stay referenced here until the
    launch is enqueued, so their memory cannot be handed to anything else
    first."""
    b, s, h, d = _check_cuda(q, k, v, g)
    for row in (lse, delta):
        if (row.shape != (b * h, s) or row.dtype != torch.float32
                or row.device != q.device):
            raise ValueError("lse and delta must be [B*H, S] f32 on q's "
                             "device")
    ins = [_aligned(x) for x in (q, k, v, g)] + [lse.contiguous(),
                                                 delta.contiguous()]
    _build.call(_lib("flash_bwd", q.dtype), fn,
                *(x.data_ptr() for x in ins + outs), b, h, s, d,
                int(causal), _DTYPE_CODES[q.dtype], _stream(q))
    launches[fn] += 1


def flash_dq(q, k, v, g, lse, delta, causal=True):
    """dQ from [B, S, H, D] q, k, v, cotangent g, and lse, delta
    [B*H, S] f32."""
    if _on_cpu(q, k, v, g, lse, delta):
        return flash_dq_plain(q, k, v, g, lse, delta, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_dq", [dq], q, k, v, g, lse, delta, causal)
    return dq


def flash_dkv(q, k, v, g, lse, delta, causal=True):
    """(dK, dV) from the same inputs as flash_dq."""
    if _on_cpu(q, k, v, g, lse, delta):
        return flash_dkv_plain(q, k, v, g, lse, delta, causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_dkv", [dk, dv], q, k, v, g, lse, delta, causal)
    return dk, dv


def flash_backward(q, k, v, out, lse, g, causal=True):
    """Residuals (q, k, v, out, lse) and cotangent g -> (dq, dk, dv)."""
    delta = _delta(out, g)
    dq = flash_dq(q, k, v, g, lse, delta, causal)
    dk, dv = flash_dkv(q, k, v, g, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Saves only the O(S) residuals (q, k, v, out, lse), as the
    reference's custom VJP does. CPU tensors take the plain versions at
    the given blocks; CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        if _on_cpu(q, k, v):
            out, lse = flash_forward_plain(q, k, v, causal, block_q, block_k)
        else:
            out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.schedule = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_k = ctx.schedule
        if _on_cpu(q, k, v, g):
            grads = flash_backward_plain(q, k, v, out, lse, g, causal,
                                         block_q, block_k)
        else:
            grads = flash_backward(q, k, v, out, lse, g, causal)
        return *grads, None, None, None


def flash_attention(q, k, v, causal=True, block_q=DEFAULT_BLOCK,
                    block_k=DEFAULT_BLOCK):
    """Flash attention; q,k,v: [B, S, H, D] -> [B, S, H, D], differentiable
    through the backward kernels. block_q/block_k schedule the plain
    versions only: CUDA tensors with other blocks than the kernels' fixed
    64 x 64 tiles raise."""
    if not _on_cpu(q, k, v) and (block_q, block_k) != (DEFAULT_BLOCK,
                                                       DEFAULT_BLOCK):
        raise ValueError(f"the CUDA flash kernels use fixed {DEFAULT_BLOCK} x "
                         f"{DEFAULT_BLOCK} tiles, not block_q={block_q}, "
                         f"block_k={block_k}")
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)
