"""The port's flash attention (dynolog_tpu_torch.ops.flash_attention) held
against the JAX package's Pallas kernels on the CPU.

The same inputs, drawn with numpy from a fixed seed, go through both:
JAX's flash runs as tests/test_ops.py runs it (Pallas interpret mode), the
port's wrappers take their plain PyTorch versions because the tensors lie
on the CPU. Tolerances are those of tests/test_ops.py: f32 forward 1e-5,
gradients 1e-4, bf16 3e-2 (one bf16 rounding of the output).
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

jfa = importlib.import_module("dynolog_tpu.ops.flash_attention")
tfa = importlib.import_module("dynolog_tpu_torch.ops.flash_attention")


def _qkv(seed, b=2, s=64, h=4, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.fixture(autouse=True)
def _no_launches():
    """The CPU path never launches a kernel."""
    tfa.reset_launches()
    yield
    assert tfa.launches == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


@pytest.mark.parametrize("seed,s,causal,bq,bk", [
    (0, 64, True, 32, 16),    # test_flash_matches_reference_causal
    (1, 48, False, 16, 16),   # test_flash_matches_reference_noncausal
    (2, 40, True, 256, 256),  # test_flash_odd_block_sizes: blocks fall to 40
])
def test_forward_matches_jax_flash(seed, s, causal, bq, bk):
    arrays = _qkv(seed, s=s)
    ref = np.asarray(jfa.flash_attention(*_jax(arrays), causal, bq, bk))
    out = tfa.flash_attention(*_torch(arrays), causal, bq, bk).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    plain = tfa.reference_attention(*_torch(arrays), causal=causal).numpy()
    np.testing.assert_allclose(out, plain, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_flash_forward(causal):
    arrays = _qkv(5, s=48)
    bh = [jfa._to_bh(x) for x in _jax(arrays)]
    ref_out, ref_lse = jfa._flash_forward(*bh, causal, 16, 16, True)
    out, lse = tfa.flash_forward_plain(*_torch(arrays), causal, 16, 16)
    assert lse.dtype == torch.float32 and lse.shape == (8, 48)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, 0],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tfa._to_bh(out).numpy(), np.asarray(ref_out),
                               rtol=0, atol=1e-5)


def test_grads_match_jax_flash():
    """Through the autograd.Function, against jax.grad of the Pallas
    custom VJP (test_flash_grad_matches_reference's case) at 1e-4."""
    arrays = _qkv(3, s=32)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, True, 16, 16) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*_jax(arrays))
    ts = [t.requires_grad_() for t in _torch(arrays)]
    (tfa.flash_attention(*ts, True, 16, 16) ** 2).sum().backward()
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4)


def test_backward_plain_matches_jax_flash_backward():
    """The plain backward against `_flash_backward` on the same residuals
    and cotangent, non-causal with uneven blocks, at 1e-4."""
    arrays = _qkv(6, s=48)
    g = np.random.default_rng(7).standard_normal(arrays[0].shape)
    g = g.astype(np.float32)
    q, k, v = _torch(arrays)
    out, lse = tfa.flash_forward_plain(q, k, v, False, 16, 24)
    ref = jfa._flash_backward(
        *[jfa._to_bh(x) for x in _jax(arrays)],
        jnp.asarray(tfa._to_bh(out).numpy()),
        jnp.asarray(lse.numpy())[:, None, :],
        jfa._to_bh(jnp.asarray(g)), False, 16, 24, True)
    got = tfa.flash_backward_plain(q, k, v, out, lse, torch.from_numpy(g),
                                   False, 16, 24)
    for t, r in zip(got, ref):
        np.testing.assert_allclose(tfa._to_bh(t).numpy(), np.asarray(r),
                                   rtol=0, atol=1e-4)


def test_bf16_matches_jax_flash():
    """test_flash_bf16's case: bf16 inputs, both sides round the f32
    result once to bf16, compared at 3e-2."""
    arrays = [a.astype(ml_dtypes.bfloat16).astype(np.float32)
              for a in _qkv(4)]
    ref = jfa.flash_attention(*_jax(arrays, jnp.bfloat16), True, 32, 32)
    out = tfa.flash_attention(*_torch(arrays, torch.bfloat16), True, 32, 32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref).astype(np.float32), rtol=0,
                               atol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    arrays = _qkv(8, s=24)
    ref = np.asarray(jfa.reference_attention(*_jax(arrays), causal=causal))
    out = tfa.reference_attention(*_torch(arrays), causal=causal).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("s,target", [(40, 256), (48, 32), (64, 64), (7, 4)])
def test_pick_block_matches_jax(s, target):
    assert tfa._pick_block(s, target) == jfa._pick_block(s, target)


def test_cpu_wrappers_take_plain_versions_at_default_blocks():
    """The kernel wrappers take no block sizes (the CUDA kernels' tiles are
    fixed): on the CPU they equal the plain versions at DEFAULT_BLOCK,
    bit for bit."""
    q, k, v = _torch(_qkv(10, s=80))
    g = torch.from_numpy(np.random.default_rng(11).standard_normal(
        q.shape).astype(np.float32))
    out, lse = tfa.flash_forward(q, k, v)
    p_out, p_lse = tfa.flash_forward_plain(q, k, v, True, tfa.DEFAULT_BLOCK,
                                           tfa.DEFAULT_BLOCK)
    assert torch.equal(out, p_out) and torch.equal(lse, p_lse)
    got = tfa.flash_backward(q, k, v, out, lse, g)
    ref = tfa.flash_backward_plain(q, k, v, out, lse, g)
    for t, r in zip(got, ref):
        assert torch.equal(t, r)


def test_wrapper_refuses_mixed_devices():
    q, k, v = _torch(_qkv(9, s=16))
    with pytest.raises(ValueError):
        tfa.flash_forward(q, k.to("meta"), v)


def _bf16_case(seed, s=64, b=2, h=4, d=16):
    """bf16 q, k, v, g drawn with numpy (the arrays are bf16-exact)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, h, d)).astype(ml_dtypes.bfloat16)
              .astype(np.float32) for _ in range(4)]
    return arrays, _torch(arrays, torch.bfloat16)


def test_round_like_kernel_keeps_f32_numerics():
    """For f32 inputs the kernels' rounding does not apply: the plain
    backward with round_like_kernel=True is the default, bit for bit."""
    q, k, v = _torch(_qkv(12, s=80))
    g = torch.from_numpy(np.random.default_rng(13).standard_normal(
        q.shape).astype(np.float32))
    out, lse = tfa.flash_forward_plain(q, k, v)
    ref = tfa.flash_backward_plain(q, k, v, out, lse, g)
    got = tfa.flash_backward_plain(q, k, v, out, lse, g,
                                   round_like_kernel=True)
    for t, r in zip(got, ref):
        assert torch.equal(t, r)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_rounding_plain_matches_jax_vjp(causal):
    """At bf16 inputs the plain backward that carries P and dS as the
    tensor-core kernels do (a pair of bf16 each) stays within relative L2
    5e-3 of the JAX package's flash_attention VJP (Pallas interpret mode).
    Observed: 1.6e-5 to 2.3e-4 (a bf16 ulp of a few output elements where
    the pair of bf16 moved the f32 sum across a rounding boundary; the
    default plain versions: 0 to 1e-6)."""
    arrays, (q, k, v, g) = _bf16_case(14)
    qj, kj, vj, gj = _jax(arrays, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal,
                                                         32, 32), qj, kj, vj)
    ref = vjp(gj)
    out, lse = tfa.flash_forward_plain(q, k, v, causal, 32, 32)
    got = tfa.flash_backward_plain(q, k, v, out, lse, g, causal, 32, 32,
                                   round_like_kernel=True)
    for t, r in zip(got, ref):
        assert t.dtype == torch.bfloat16
        r = np.asarray(r).astype(np.float32)
        err = np.linalg.norm(t.float().numpy() - r) / np.linalg.norm(r)
        assert err <= 5e-3, err


def test_rounding_plain_dv_is_split_p_times_do():
    """The rounding plain dV is a dense, unblocked split(P)^T dO, with
    split(P) = bf16(P) + bf16(P - bf16(P)), within 1e-6: the rounding sits
    where the kernel puts it. A single bf16 rounding of P gives another
    dV."""
    _, (q, k, v, g) = _bf16_case(15)
    b, s, h, d = q.shape
    out, lse = tfa.flash_forward_plain(q, k, v, True, s, s)
    delta = tfa._delta(out, g)
    _, dv = tfa.flash_dkv_plain(q, k, v, g, lse, delta, True, s, s,
                                round_like_kernel=True)
    scale = tfa._scale(d)
    scores = tfa._to_bh(q).float() @ tfa._to_bh(k).float().mT * scale
    scores = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), scores,
                         tfa._NEG_INF)
    p = torch.exp(scores - lse[..., None])
    hi = p.to(torch.bfloat16).float()
    split = hi + (p - hi).to(torch.bfloat16).float()
    dense = tfa._from_bh((split.mT @ tfa._to_bh(g).float())
                         .to(torch.bfloat16), b, h)
    np.testing.assert_allclose(dv.float().numpy(), dense.float().numpy(),
                               rtol=0, atol=1e-6)
    once = tfa._from_bh((hi.mT @ tfa._to_bh(g).float()).to(torch.bfloat16),
                        b, h)
    assert not torch.equal(once, dv)


def test_backward_launch_picks_library_by_dtype(monkeypatch):
    """bf16 goes to the tensor-core library, f32 to the CUDA-core one; the
    entry points and their arguments are the same."""
    calls = []
    monkeypatch.setattr(tfa._build, "call",
                        lambda lib, fn, *args: calls.append((lib, fn,
                                                             len(args))))
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _torch(_qkv(16, s=8), dtype)
        rows = torch.zeros(8, 8)
        tfa._launch_bwd("flash_dq", [q], q, k, v, q, rows, rows, True)
        tfa._launch_bwd("flash_dkv", [k, v], q, k, v, q, rows, rows, True)
    assert calls == [("flash_bwd_sm90", "flash_dq", 14),
                     ("flash_bwd_sm90", "flash_dkv", 15),
                     ("flash_bwd", "flash_dq", 14),
                     ("flash_bwd", "flash_dkv", 15)]
    assert tfa.launches == {"flash_fwd": 0, "flash_dq": 2, "flash_dkv": 2}
    tfa.reset_launches()


def test_forward_launch_picks_library_by_dtype(monkeypatch):
    """bf16 goes to the tensor-core forward (flash_fwd_sm90), f32 to the
    CUDA-core one; the entry point and its arguments are the same, and
    every pointer handed to the kernel starts on a 16-byte boundary."""
    calls = []
    monkeypatch.setattr(tfa._build, "call",
                        lambda lib, fn, *args: calls.append((lib, fn, args)))
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _torch(_qkv(17, s=8), dtype)
        out, lse = tfa._launch_fwd(q, k, v, True)
        assert out.shape == q.shape and out.dtype == dtype
        assert lse.shape == (8, 8) and lse.dtype == torch.float32
    assert [(lib, fn, len(args)) for lib, fn, args in calls] == [
        ("flash_fwd_sm90", "flash_fwd", 12), ("flash_fwd", "flash_fwd", 12)]
    for (_, _, args), dtype in zip(calls, (torch.bfloat16, torch.float32)):
        assert all(ptr % 16 == 0 for ptr in args[:5])
        assert args[5:11] == (2, 4, 8, 16, 1, tfa._DTYPE_CODES[dtype])
    assert tfa.launches == {"flash_fwd": 2, "flash_dq": 0, "flash_dkv": 0}
    tfa.reset_launches()


def test_forward_launch_hands_an_offset_view_over_as_an_aligned_copy(
        monkeypatch):
    """A bf16 view that starts off a 16-byte boundary reaches the forward
    kernel as an aligned copy with the same values; aligned inputs are
    passed as they are."""
    seen = []

    def call(lib, fn, *args):
        seen.append(args[:3])

    monkeypatch.setattr(tfa._build, "call", call)
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    b, s, h, d = 1, 8, 2, 16
    base = torch.randn(b * s * h * d + 1).to(torch.bfloat16)
    q = base[1:].view(b, s, h, d)
    k, v = (torch.randn(b, s, h, d).to(torch.bfloat16) for _ in range(2))
    assert q.data_ptr() % 16 != 0
    tfa._launch_fwd(q, k, v, True)
    q_ptr, k_ptr, v_ptr = seen[0]
    assert q_ptr % 16 == 0 and q_ptr != q.data_ptr()
    assert (k_ptr, v_ptr) == (k.data_ptr(), v.data_ptr())
    assert torch.equal(tfa._aligned(q), q)
    tfa.reset_launches()


def test_aligned_copies_only_an_offset_view():
    """The tensor maps need a 16-byte aligned start: a view that starts
    off one is copied, an aligned tensor is passed as it is."""
    base = torch.zeros(4 * 64, dtype=torch.bfloat16)
    assert tfa._aligned(base).data_ptr() == base.data_ptr()
    view = base[1:129]
    got = tfa._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
