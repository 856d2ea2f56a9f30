"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here is marked ``gpu`` and skips inside the ``cuda`` fixture
where ``torch.cuda.is_available()`` is false.  The file imports neither
``jax`` nor ``repro`` (the machine with the card has no JAX), so it runs
there as

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|) — f32 sums
taken in another order; ``kmeans_assign`` labels may differ only on
near-ties.  ``flash_attention`` elementwise: |kernel - plain| <= atol +
rtol * |plain|, (rtol, atol) = (2e-5, 2e-5) in f32 and (1e-2, 4e-3) in
bf16 (``chip_smoke.FLASH_TOL``, tighter than the JAX flash tests' 2e-2).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import (block_matvec as bmv,
                                 flash_attention as fa,
                                 fused_rbf_matmat as frm, kmeans_assign as ka,
                                 ops, rbf_similarity as rbf)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _case(seed, n, m, d, b):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(m, d).astype(np.float32)
    V = rng.randn(m, b).astype(np.float32)
    rs = rng.uniform(0.1, 1.0, n).astype(np.float32)
    cs = rng.uniform(0.1, 1.0, m).astype(np.float32)
    rs[::7] = 0.0
    cs[::5] = 0.0
    return x, y, V, rs, cs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,b", [(8191, 8192, 1), (8192, 8191, 8),
                                   (1000, 999, 64), (70, 3, 5)])
def test_gpu_fused_rbf_kernel_matches_plain(cuda, n, m, b):
    x, y, V, rs, cs = _case(b, n, m, 32, b)
    x[7] = 1e4                              # isolated point
    args = [_t(a).to(cuda) for a in (x, y, V)]
    rs_t, cs_t = _t(rs).to(cuda), _t(cs).to(cuda)
    launches = frm.fused_rbf_matmat.launches
    got = frm.fused_rbf_matmat(*args, 4.0, rs_t, cs_t)
    torch.cuda.synchronize()
    assert frm.fused_rbf_matmat.launches == launches + 1
    want = frm.fused_rbf_matmat_plain(*args, 4.0, rs_t, cs_t)
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,b", [(4095, 8191, 8), (16, 300, 63)])
def test_gpu_fused_nystrom_kernel_matches_plain(cuda, m, n, b):
    x, y, V, _, cs = _case(m, m, n, 32, b)
    cv = np.ones(n, np.float32)
    cv[::6] = 0.0
    cs[::6] = 0.0
    args = [_t(a).to(cuda) for a in (x, y, V)]
    got = frm.fused_nystrom_matmat(*args, 4.0, _t(cs).to(cuda),
                                   _t(cv).to(cuda))
    want = frm.fused_nystrom_matmat_plain(*args, 4.0, _t(cs).to(cuda),
                                          _t(cv).to(cuda))
    torch.cuda.synchronize()
    assert _rel_err(got[0], want[0]) <= 1e-4
    assert _rel_err(got[1], want[1]) <= 1e-4


@pytest.mark.gpu
def test_gpu_kmeans_assign_kernel_matches_plain(cuda):
    rng = np.random.RandomState(0)
    p = _t(rng.randn(131072, 8)).to(cuda)
    c = _t(rng.randn(8, 8)).to(cuda)
    idx, dist = ka.kmeans_assign(p, c)
    idx_r, dist_r = ka.kmeans_assign_plain(p, c)
    torch.cuda.synchronize()
    assert _rel_err(dist, dist_r) <= 1e-4
    d2 = torch.cdist(p, c) ** 2
    gap = (d2.gather(1, idx[:, None]) - d2.gather(1, idx_r[:, None])).abs()
    assert bool((gap[idx != idx_r] <= 1e-4).all())   # only near-ties differ
    dup = torch.cat([c[:1], c]).contiguous()
    assert int(ka.kmeans_assign(c, dup)[0][0]) == 0   # tie -> lowest index


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d", [(1000, 777, 3), (4097, 4095, 32),
                                   (64, 70, 33), (1, 5, 2)])
def test_gpu_rbf_similarity_kernel_matches_plain(cuda, n, m, d):
    """Ragged edges (no tile multiple, m % 4 != 0) and d past one chunk."""
    x, y, _, _, _ = _case(n + d, n, m, d, 1)
    x[0] = 1e4                              # isolated point: exact zeros
    xt, yt = _t(x).to(cuda), _t(y).to(cuda)
    launches = rbf.rbf_similarity.launches
    got = rbf.rbf_similarity(xt, yt, 2.0)
    torch.cuda.synchronize()
    assert rbf.rbf_similarity.launches == launches + 1
    assert got.shape == (n, m)
    assert _rel_err(got, rbf.rbf_similarity_plain(xt, yt, 2.0)) <= 1e-4


@pytest.mark.gpu
def test_gpu_rbf_similarity_past_two_to_the_31(cuda):
    """40000 x 60000 outputs: the last stripe lies past element 2^31."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((40000, 32), generator=g, device=cuda)
    y = torch.randn((60000, 32), generator=g, device=cuda)
    S = rbf.rbf_similarity(x, y, 6.0)
    for r0 in (0, 40000 - 1024):
        want = rbf.rbf_similarity_plain(x[r0:r0 + 1024], y, 6.0)
        assert _rel_err(S[r0:r0 + 1024], want) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,b", [(1000, 777, 1), (1000, 777, 3),
                                   (8191, 8193, 8), (300, 129, 17),
                                   (70, 5, 64), (5, 0, 2)])
def test_gpu_block_matmat_kernel_matches_plain(cuda, n, m, b):
    rng = np.random.RandomState(n + b)
    A = _t(rng.randn(n, m)).to(cuda)
    V = _t(rng.randn(m, b)).to(cuda)
    launches = bmv.block_matmat.launches
    got = bmv.block_matmat(A, V)
    torch.cuda.synchronize()
    assert bmv.block_matmat.launches == launches + 1
    assert _rel_err(got, bmv.block_matmat_plain(A, V)) <= 1e-4
    if b == 1:
        assert _rel_err(bmv.block_matvec(A, V[:, 0]), (A @ V)[:, 0]) <= 1e-4


@pytest.mark.gpu
def test_gpu_block_matmat_past_two_to_the_31_and_wide_blocks(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    A = torch.rand((40000, 60000), generator=g, device=cuda)
    V = torch.randn((60000, 8), generator=g, device=cuda)
    got = bmv.block_matmat(A, V)
    want = bmv.block_matmat_plain(A, V)
    assert _rel_err(got[-1024:], want[-1024:]) <= 1e-4
    assert _rel_err(got, want) <= 1e-4
    del A
    W = torch.randn((150, 150), generator=g, device=cuda)
    launches = bmv.block_matmat.launches
    wide = ops.block_matmat(W[:100], W)           # 150 = 64 + 64 + 22
    assert bmv.block_matmat.launches == launches + 3
    assert _rel_err(wide, W[:100] @ W) <= 1e-4
    with pytest.raises(ValueError, match="contiguous"):
        bmv.block_matmat(W.T, W[:, :4])


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,S,T,hd,dtype,causal,window", [
    (1, 4, 1, 1000, 1000, 256, "bfloat16", True, 512),   # ragged, window
    (2, 6, 2, 1000, 1000, 128, "float32", True, -1),     # ragged, GQA
    (1, 2, 2, 300, 700, 64, "float32", False, -1),       # non-causal S < T
    (1, 3, 3, 129, 129, 64, "bfloat16", True, 16),       # window < tile
    (1, 2, 1, 513, 513, 256, "float32", True, 64),
    (1, 2, 1, 300, 40, 256, "bfloat16", False, 8),       # rows see no key
    (1, 2, 1, 300, 40, 64, "float32", True, 8),
    (2, 4, 4, 100, 100, 16, "float32", True, -1),        # smoke widths
    (2, 4, 2, 100, 130, 64, "bfloat16", False, -1)])
def test_gpu_flash_attention_kernel_matches_plain(cuda, B, H, KV, S, T, hd,
                                                  dtype, causal, window):
    g = torch.Generator(device=cuda).manual_seed(S + hd)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dt)
               for shape in ((B, H, S, hd), (B, KV, T, hd), (B, KV, T, hd)))
    launches = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    assert got.dtype == dt and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal, window)
    rtol, atol = (2e-5, 2e-5) if dtype == "float32" else (1e-2, 4e-3)
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all())


@pytest.mark.gpu
def test_gpu_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 1, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


@pytest.mark.gpu
def test_gpu_lm_flash_route_launches_the_kernel_per_layer(cuda):
    """qwen1.5's smoke config (4 heads of 16): a prefill on the flash
    route launches the kernel once a layer and matches the CPU's plain
    route within 2e-4 * max |logits| (f32)."""
    from repro_torch import configs
    from repro_torch.models import api, params as pp
    cfg = configs.get_smoke("qwen1.5-0.5b").with_(
        compute_dtype=torch.float32, use_flash_attention=True)
    cpu = api.build(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 40)))
    want, _ = cpu.prefill(params, {"tokens": toks})
    card = api.build(cfg, cuda)
    launches = fa.flash_attention.launches
    got, _ = card.prefill(pp.tree_map(lambda t: t.to(cuda), params),
                          {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + cfg.num_layers
    assert float((got.cpu() - want).abs().max()) <= \
        2e-4 * float(want.abs().max())
