#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root, one card

Phases, each fatal on failure (non-zero exit, no result line):

1. print the card's name and power limit (``nvidia-smi``) and build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all at once);
2. hold every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (n = 131072 points, d = 32) and at
   edge cases (ragged sizes, zero scales, an isolated point, width 64),
   and time kernel and plain version with CUDA events;
3. a small-input reference: a fit of 4096 points on the card against the
   same fit on the CPU through the plain versions (eigenvalues within
   1e-3, labels ARI >= 0.99); as the first fit of the process it also
   carries the one-time set-up, so the main path starts warm;
4. the fused main path, with every launch counter set to 0 just before
   it: ``SpectralClustering(8, affinity="fused-rbf", eigensolver=...,
   assigner="lloyd").fit`` on 131072 blobs points with ``block-lanczos``
   and on the first 32768 of them with ``lanczos`` (ARI >= 0.99 against
   the planted labels), then
   4 ``predict`` requests of 16384 held-out points (fused route, ARI >=
   0.99); every kernel's counter must have risen;
5. the dense family's kernels against their plain versions at its shapes
   (``rbf_similarity`` and ``block_matmat`` at n = m = 65536, row stripes
   4096 rows long at both ends of S, the last past element 2^31, and
   ragged cases), timed beside ``torch.matmul``;
6. the dense path, counters set to 0 just before it: fits of 65536
   points with ``dense``, ``knn-topt`` and ``precomputed`` (on the S that
   ``rbf_similarity`` built; labels equal to the ``dense`` fit's), each
   ARI >= 0.99; the ``eigh`` oracle's eigenvalues against
   ``block-lanczos`` at n = 8192; the dense fit saved, loaded and serving
   16384 held-out points with the labels of the fitted model;
7. ``flash_attention`` against its plain version at the LM path's shape
   (qwen1.5-0.5b prefill: B = 1, 16 heads of 64, S = T = 2048, causal,
   bf16) and at edge cases (ragged S, GQA 16/4, window 64, non-causal
   S != T, S = T = 1, hd 16, 128 and 256, f32), elementwise within
   atol + rtol * |plain|, the path's shape timed beside
   ``scaled_dot_product_attention``;
8. a small LM on the card against the CPU: qwen1.5's smoke config, f32,
   flash route, prefill + 4 decode steps on the same weights, logits
   within 2e-4 * max |logits|;
9. the LM serving path, counters set to 0 just before it: qwen1.5-0.5b at
   full width and depth (bf16 compute, random weights from a seed) behind
   ``repro_torch.launch.serve.Server`` with ``serve.main``'s traffic and
   2048-token prompts (4 slots, 8 requests, max_seq = prompt + 12 + 8);
   every request completes with its budget, and the run launches
   ``flash_attention`` exactly 24 * (1 + 8) times (the dummy batch
   prefill and one prefill a request);
10. the kernel route against the plain route at full width in f32: one
   2048-token prompt through the flash route (the kernel) and the dense
   route (``_sdpa_dense``): prefill logits and KV cache within 2e-3 * max,
   and the greedy token of every position equal wherever its top-1/top-2
   margin exceeds that limit.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N, D, K = 131072, 32, 8          # training points, features, clusters
N_LANCZOS = 32768                # the single-vector lanczos fit's points
M_REQ, N_REQ = 16384, 4          # predict requests: rows each, count
ARI_MIN = 0.99
TOL = 1e-4        # kernel vs plain: max |err| / max(1, max |plain|)
EIG_TOL = 1e-3    # card fit vs CPU fit eigenvalues (small input)
EIGH_TOL = 1e-4   # eigh vs block-lanczos eigenvalues (dense, n = N_EIGH)
# H100 SXM data sheet, 700 W: HBM rate, f32 non-tensor and bf16 tensor peaks
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
N_DENSE = 65536                  # dense path: 4 n^2 bytes = 16 GiB of S
N_EIGH = 8192                    # the eigh oracle's size
STRIPE = 4096                    # rows of S compared with the plain version
# knn-topt's Krylov dimension: the top-10 graph's eigengap is far smaller
# than the dense graph's, and the default 32 does not resolve 8 clusters
KNN_LANCZOS_STEPS = 256
# the LM serving path: serve.main's traffic with 2048-token prompts
LM_ARCH = "qwen1.5-0.5b"
LM_SLOTS, LM_REQUESTS, LM_PROMPT, LM_GEN = 4, 8, 2048, 12
LM_MAX_SEQ = LM_PROMPT + LM_GEN + 8               # as serve.main sets it
# small LM, card vs CPU, f32, x max |logits|: the CPU parity tests'
# whole-model limit (tests/test_torch_models.py)
LM_REF_TOL = 2e-4
# kernel route vs plain route at full width, f32, x max |logits|: the JAX
# package's limit between two attention routes of one f32 model
# (tests/test_models.py:76); a wrong kernel differs by O(1)
LM_ROUTE_TOL = 2e-3
# flash_attention vs plain, elementwise: |err| <= atol + rtol * |plain|,
# (rtol, atol) by dtype.  Tighter than the JAX flash tests' allclose
# (tests/test_kernels_flash.py:28, atol = rtol = 2e-2 in bf16).  bf16: the
# outputs of both are rounded to bf16 (1 ulp <= 2^-7 of the value, inside
# rtol), and the kernel rounds p to bf16 before the PV product (2^-9 of
# each term p v, up to ~4e-3 on an output near 0 where |v| reaches 4).
FLASH_TOL = {"bfloat16": (1e-2, 4e-3), "float32": (2e-5, 2e-5)}
# name, B, H, KV, S, T, hd, dtype, causal, window; the first is the path's
FLASH_CASES = (
    ("path", 1, 16, 16, 2048, 2048, 64, "bfloat16", True, -1),
    ("ragged S", 2, 16, 16, 1000, 1000, 64, "bfloat16", True, -1),
    ("GQA 16/4", 1, 16, 4, 2048, 2048, 64, "bfloat16", True, -1),
    ("window 64", 1, 16, 16, 2048, 2048, 64, "bfloat16", True, 64),
    ("non-causal S != T", 1, 16, 16, 1000, 1500, 64, "bfloat16", False,
     -1),
    ("S = T = 1", 1, 16, 16, 1, 1, 64, "bfloat16", True, -1),
    ("hd 16 (smoke)", 2, 4, 4, 300, 300, 16, "bfloat16", True, -1),
    ("hd 128", 1, 8, 2, 1000, 1000, 128, "bfloat16", True, -1),
    ("hd 256, window", 1, 4, 1, 1000, 1000, 256, "bfloat16", True, 512),
    ("f32", 1, 16, 16, 2048, 2048, 64, "float32", True, -1),
    ("f32 hd 256, non-causal", 1, 2, 1, 513, 700, 256, "float32", False,
     -1),
)


T_START = time.perf_counter()


def phase(title: str) -> None:
    """Print a phase's header with the seconds since the script began."""
    print(f"phase {title} [{time.perf_counter() - T_START:.1f} s]:")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS
          ) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, name, got, want, tol=TOL) -> float:
    """Max abs error of ``got`` against ``want``; fails past ``tol`` times
    max(1, max |want|)."""
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    finite = bool(torch.isfinite(got).all())
    print(f"  {name}: max_abs_err {err:.3e} (limit {tol * scale:.3e})"
          f"{'' if finite else ' NON-FINITE'}")
    if not finite or err > tol * scale:
        fail(f"{name} disagrees with its plain version")
    return err


def check_kernels(torch, x, sigma, dev):
    """Phase 2: every kernel against its plain version, plus timings."""
    from repro_torch.kernels import (fused_rbf_matmat as frm,
                                     kmeans_assign as ka)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rows = {}

    # -- fused_rbf_matmat at the main path's shapes ----------------------
    n = x.shape[0]
    ones = torch.ones((n,), device=dev)
    scale = torch.rand((n,), generator=g, device=dev) * 0.01
    V8 = torch.randn((n, 8), generator=g, device=dev)
    err1 = compare(torch, f"fused_rbf_matmat n={n} d={D} b=1 (degree pass)",
                   frm.fused_rbf_matmat(x, x, ones[:, None], sigma, ones,
                                        ones),
                   frm.fused_rbf_matmat_plain(x, x, ones[:, None], sigma,
                                              ones, ones))
    err8 = compare(torch, f"fused_rbf_matmat n={n} d={D} b=8",
                   frm.fused_rbf_matmat(x, x, V8, sigma, scale, scale),
                   frm.fused_rbf_matmat_plain(x, x, V8, sigma, scale, scale))
    # edge cases: ragged sizes, zero scales, an isolated point, width 64
    xe = x[:8192].clone()
    xe[7] = 1e4
    for ne, me, b in [(8191, 8192, 1), (8192, 8191, 8), (8191, 8191, 64)]:
        Ve = torch.randn((me, b), generator=g, device=dev)
        rs = torch.rand((ne,), generator=g, device=dev)
        cs = torch.rand((me,), generator=g, device=dev)
        rs[::7] = 0.0
        cs[::5] = 0.0
        compare(torch, f"fused_rbf_matmat n={ne} m={me} b={b} "
                f"(zero scales, isolated point)",
                frm.fused_rbf_matmat(xe[:ne], xe[:me], Ve, sigma, rs, cs),
                frm.fused_rbf_matmat_plain(xe[:ne], xe[:me], Ve, sigma, rs,
                                           cs))
    fl = lambda b: 2 * n * n * D + 2 * n * n * b + 5 * n * n  # noqa: E731
    by = lambda b: 4 * (2 * n * D + 2 * n * b + 2 * n)        # noqa: E731
    t8 = time_ms(torch, lambda: frm.fused_rbf_matmat(x, x, V8, sigma, scale,
                                                     scale), 5)
    p8 = time_ms(torch, lambda: frm.fused_rbf_matmat_plain(
        x, x, V8, sigma, scale, scale), 2)
    t1 = time_ms(torch, lambda: frm.fused_rbf_matmat(
        x, x, ones[:, None], sigma, ones, ones), 5)
    p1 = time_ms(torch, lambda: frm.fused_rbf_matmat_plain(
        x, x, ones[:, None], sigma, ones, ones), 2)
    b8, b8_by = bound(fl(8), by(8))
    b1, b1_by = bound(fl(1), by(1))
    print(f"  timing fused_rbf_matmat n=m={n} d={D} b=8: kernel {t8:.3f} ms,"
          f" plain {p8:.3f} ms, bound {b8:.3f} ms ({b8_by})")
    print(f"  timing fused_rbf_matmat n=m={n} d={D} b=1: kernel {t1:.3f} ms,"
          f" plain {p1:.3f} ms, bound {b1:.3f} ms ({b1_by})")
    rows["fused_rbf_matmat"] = dict(
        source="src/repro_torch/kernels/csrc/fused_rbf.cu",
        replaces="src/repro/kernels/fused_rbf_matmat.py:286",
        shape=f"n=m={n} d={D} b=8", max_abs_err=max(err1, err8), ms=t8,
        plain_ms=p8, bound_ms=b8, bound_by=b8_by, library_ms=None,
        b1=dict(ms=t1, plain_ms=p1, bound_ms=b1, bound_by=b1_by))

    # -- fused_nystrom_matmat: M_REQ queries against the training set ----
    q = x[:M_REQ] + 0.01 * torch.randn((M_REQ, D), generator=g, device=dev)
    Z = torch.randn((n, K), generator=g, device=dev)
    cs = torch.rand((n,), generator=g, device=dev) * 0.01
    O, dg = frm.fused_nystrom_matmat(q, x, Z, sigma, cs, ones)
    Or, dgr = frm.fused_nystrom_matmat_plain(q, x, Z, sigma, cs, ones)
    errn = max(compare(torch, f"fused_nystrom_matmat m={M_REQ} n={n} k={K}"
                       f" (product)", O, Or),
               compare(torch, f"fused_nystrom_matmat m={M_REQ} n={n} k={K}"
                       f" (degree)", dg, dgr))
    cse, cve = cs[:8191].clone(), ones[:8191].clone()
    cse[::5] = 0.0                  # isolated training points: valid, no
    cve[::10] = 0.0                 # product weight; invalid rows: neither
    Oe, dge = frm.fused_nystrom_matmat(q[:4095], xe[:8191], Z[:8191], sigma,
                                       cse, cve)
    Oer, dger = frm.fused_nystrom_matmat_plain(q[:4095], xe[:8191],
                                               Z[:8191], sigma, cse, cve)
    compare(torch, "fused_nystrom_matmat m=4095 n=8191 (masked rows)", Oe,
            Oer)
    compare(torch, "fused_nystrom_matmat m=4095 n=8191 (masked degree)",
            dge, dger)
    m = M_REQ
    tn = time_ms(torch, lambda: frm.fused_nystrom_matmat(q, x, Z, sigma, cs,
                                                         ones), 5)
    pn = time_ms(torch, lambda: frm.fused_nystrom_matmat_plain(
        q, x, Z, sigma, cs, ones), 2)
    bn, bn_by = bound(2 * m * n * D + 2 * m * n * (K + 1) + 5 * m * n,
                      4 * (m * D + n * D + n * K + 2 * n + m * K + m))
    print(f"  timing fused_nystrom_matmat m={m} n={n} k={K}: kernel "
          f"{tn:.3f} ms, plain {pn:.3f} ms, bound {bn:.3f} ms ({bn_by})")
    rows["fused_nystrom_matmat"] = dict(
        source="src/repro_torch/kernels/csrc/fused_rbf.cu",
        replaces="src/repro/kernels/fused_rbf_matmat.py:222",
        shape=f"m={m} n={n} d={D} k={K}", max_abs_err=errn, ms=tn,
        plain_ms=pn, bound_ms=bn, bound_by=bn_by, library_ms=None)

    # -- kmeans_assign at n points of the k-dim embedding ----------------
    P = torch.randn((n, K), generator=g, device=dev)
    C = torch.randn((K, K), generator=g, device=dev)
    idx, dist = ka.kmeans_assign(P, C)
    idx_r, dist_r = ka.kmeans_assign_plain(P, C)
    errk = compare(torch, f"kmeans_assign n={n} k={K} (distances)", dist,
                   dist_r)
    d2 = torch.clamp_min((P * P).sum(1)[:, None] + (C * C).sum(1)[None, :]
                         - 2.0 * P @ C.T, 0.0)
    diff = idx != idx_r
    gap = (d2.gather(1, idx[:, None]) - d2.gather(1, idx_r[:, None])).abs()
    near_tie = gap[:, 0] <= TOL * torch.clamp_min(dist_r, 1.0)
    print(f"  kmeans_assign n={n} k={K}: {int(diff.sum())} labels differ, "
          f"all near-ties: {bool(near_tie[diff].all())}")
    if not bool(near_tie[diff].all()):
        fail("kmeans_assign picks another center than its plain version")
    tie = torch.zeros((64, K), device=dev)        # all centers equidistant
    if int(ka.kmeans_assign(tie, torch.zeros((K, K), device=dev))[0]
           .max()) != 0:
        fail("kmeans_assign ties must resolve to the lowest index")
    tk = time_ms(torch, lambda: ka.kmeans_assign(P, C), 20)
    pk = time_ms(torch, lambda: ka.kmeans_assign_plain(P, C), 20)
    bk, bk_by = bound(2 * n * K * K + 2 * n * K + 4 * n * K,
                      4 * n * K + 4 * K * K + 12 * n)
    print(f"  timing kmeans_assign n={n} k={K}: kernel {tk:.4f} ms, plain "
          f"{pk:.4f} ms, bound {bk:.4f} ms ({bk_by})")
    rows["kmeans_assign"] = dict(
        source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign.py:33",
        shape=f"n={n} k={K} dim={K}", max_abs_err=errk, ms=tk, plain_ms=pk,
        bound_ms=bk, bound_by=bk_by, library_ms=None)
    return rows


def compare_close(torch, name, got, want, rtol, atol) -> float:
    """Max abs error of ``got`` against ``want``; fails where any element
    is past ``atol + rtol * |want|``."""
    err = (got - want).abs()
    worst = float((err / (atol + rtol * want.abs())).max())
    finite = bool(torch.isfinite(got).all())
    print(f"  {name}: max_abs_err {float(err.max()):.3e}, worst |err| / "
          f"({atol:g} + {rtol:g} |plain|) {worst:.3f}"
          f"{'' if finite else ' NON-FINITE'}")
    if not finite or worst > 1.0:
        fail(f"{name} disagrees with its plain version")
    return float(err.max())


def check_dense_kernels(torch, x, sigma, dev):
    """Phase 5: ``rbf_similarity`` and ``block_matmat`` against their
    plain versions at the dense path's shapes, plus timings."""
    from repro_torch.kernels import block_matvec as bmv, rbf_similarity as rbf
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    rows = {}
    n = x.shape[0]

    # -- rbf_similarity: S of the dense path, two stripes, ragged cases --
    S = rbf.rbf_similarity(x, x, sigma)
    errs = []
    for r0 in (0, n - STRIPE):
        past = (r0 + STRIPE) * n > 2 ** 31
        errs.append(compare(
            torch, f"rbf_similarity n=m={n} d={D} rows {r0}..{r0 + STRIPE}"
            f"{' (past element 2^31)' if past else ''}", S[r0:r0 + STRIPE],
            rbf.rbf_similarity_plain(x[r0:r0 + STRIPE], x, sigma)))
    for ne, me, de in [(1000, 777, 3), (4097, 4095, 33), (1, 5, 2)]:
        a = torch.randn((ne, de), generator=g, device=dev)
        b = torch.randn((me, de), generator=g, device=dev)
        a[0] = 1e4                                   # isolated point
        compare(torch, f"rbf_similarity n={ne} m={me} d={de} (ragged)",
                rbf.rbf_similarity(a, b, 2.0),
                rbf.rbf_similarity_plain(a, b, 2.0))
    tr = time_ms(torch, lambda: rbf.rbf_similarity(x, x, sigma), 3)
    pr = time_ms(torch, lambda: rbf.rbf_similarity_plain(x, x, sigma), 1)
    br, br_by = bound(2 * n * n * D + 2 * 2 * n * D + 6 * n * n,
                      4 * (2 * n * D + n * n))
    print(f"  timing rbf_similarity n=m={n} d={D}: kernel {tr:.3f} ms, "
          f"plain {pr:.3f} ms, bound {br:.3f} ms ({br_by})")
    rows["rbf_similarity"] = dict(
        source="src/repro_torch/kernels/csrc/rbf_similarity.cu",
        replaces="src/repro/kernels/rbf_similarity.py:35",
        shape=f"n=m={n} d={D}", max_abs_err=max(errs), ms=tr, plain_ms=pr,
        bound_ms=br, bound_by=br_by, library_ms=None)
    gc.collect()
    torch.cuda.empty_cache()

    # -- block_matmat: the dense operator's pass over that S -------------
    timing = {}
    for b in (8, 1):
        V = torch.randn((n, b), generator=g, device=dev)
        err = compare(torch, f"block_matmat n=m={n} b={b}",
                      bmv.block_matmat(S, V), bmv.block_matmat_plain(S, V))
        t = time_ms(torch, lambda: bmv.block_matmat(S, V), 5)
        p = time_ms(torch, lambda: bmv.block_matmat_plain(S, V), 5)
        lib = time_ms(torch, lambda: torch.matmul(S, V), 5)
        bb, bb_by = bound(2 * n * n * b, 4 * (n * n + 2 * n * b))
        print(f"  timing block_matmat n=m={n} b={b}: kernel {t:.3f} ms, "
              f"plain {p:.3f} ms, torch.matmul {lib:.3f} ms, bound "
              f"{bb:.3f} ms ({bb_by})")
        timing[b] = dict(max_abs_err=err, ms=t, plain_ms=p, bound_ms=bb,
                         bound_by=bb_by, library_ms=lib)
    for ne, me, b in [(1000, 777, 1), (1000, 777, 3), (8191, 8193, 8),
                      (300, 129, 17), (70, 5, 64)]:
        A = torch.rand((ne, me), generator=g, device=dev)
        V = torch.randn((me, b), generator=g, device=dev)
        compare(torch, f"block_matmat n={ne} m={me} b={b} (ragged)",
                bmv.block_matmat(A, V), bmv.block_matmat_plain(A, V))
    rows["block_matmat"] = dict(
        source="src/repro_torch/kernels/csrc/block_matmat.cu",
        replaces="src/repro/kernels/block_matvec.py:111",
        shape=f"n=m={n} b=8", **dict(timing[8], max_abs_err=max(
            timing[8]["max_abs_err"], timing[1]["max_abs_err"])),
        b1=timing[1])
    return rows


def dense_path(torch, np, pts, truth, kernels):
    """Phase 6: the dense family's fits, the eigh oracle and save/load;
    returns the launch counts of the phase."""
    from repro_torch import SpectralClustering, ari
    from repro_torch.core.similarity import median_sigma
    from repro_torch.kernels import ops
    n = N_DENSE
    x = pts[:n]
    limit = 3 * 4 * n * n

    def run(label, fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = {k: f.launches for k, f in kernels.items()}
        t0 = time.perf_counter()
        est = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: f.launches - before[k] for k, f in kernels.items()}
        labels = est.labels_.cpu().numpy()
        evals = est.eigenvalues_.cpu().numpy()
        score = ari(truth[:n], labels)
        print(f"  {label}: wall {wall:.3f} s, phases "
              f"{ {k: round(v, 4) for k, v in est.info_['phase_s'].items()} },"
              f" matrix_passes {est.info_['matrix_passes']}, launches "
              f"{launches}, peak {peak / 2**30:.2f} GiB")
        print(f"    eigenvalues {np.array2string(evals, precision=6)}")
        print(f"    ARI vs planted labels {score:.6f}")
        if labels.shape != (n,) or not np.isfinite(evals).all():
            fail(f"{label}: bad labels shape or eigenvalues")
        if score < ARI_MIN:
            fail(f"{label}: ARI {score:.4f} < {ARI_MIN}")
        if launches["block_matmat"] <= 0 or launches["rbf_similarity"] <= 0:
            fail(f"{label}: the dense kernels were not launched")
        return est, peak

    def fit(affinity, data, **kw):
        return SpectralClustering(K, affinity=affinity,
                                  eigensolver="block-lanczos",
                                  assigner="lloyd", seed=0, **kw).fit(data)

    for f in kernels.values():
        f.launches = 0
    dense, peak = run("fit dense", lambda: fit("dense", x))
    if peak >= limit:
        fail(f"dense fit peak {peak} B >= 3 * 4 n^2 = {limit} B")
    run("fit knn-topt", lambda: fit("knn-topt", x,
                                    lanczos_steps=KNN_LANCZOS_STEPS))

    def precomputed():
        xt = torch.as_tensor(x, device=dense.device)
        S = ops.rbf_similarity(xt, xt, median_sigma(xt))
        return fit("precomputed", S)
    pre, _ = run("S build + fit precomputed", precomputed)
    same = ari(dense.labels_.cpu().numpy(), pre.labels_.cpu().numpy())
    print(f"  precomputed vs dense labels: ARI {same:.6f}, equal "
          f"{bool((dense.labels_ == pre.labels_).all())}")
    if same != 1.0:
        fail("the precomputed fit on the kernel's S disagrees with dense")
    del pre
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"eigh oracle (dense, n={N_EIGH})")
    ev = {}
    for solver in ("eigh", "block-lanczos"):
        t0 = time.perf_counter()
        est = SpectralClustering(K, affinity="dense", eigensolver=solver,
                                 seed=0).fit(x[:N_EIGH])
        torch.cuda.synchronize()
        ev[solver] = est.eigenvalues_.cpu().numpy()
        print(f"  {solver}: wall {time.perf_counter() - t0:.3f} s, "
              f"eigenvalues {np.array2string(ev[solver], precision=7)}")
    diff = float(np.abs(ev["eigh"] - ev["block-lanczos"]).max())
    print(f"  eigh vs block-lanczos: max eigenvalue diff {diff:.3e} "
          f"(limit {EIGH_TOL})")
    if not diff <= EIGH_TOL:
        fail("eigh and block-lanczos eigenvalues disagree")

    phase(f"save/load (dense fit, n={n})")
    held = pts[n:n + M_REQ]
    directory = tempfile.mkdtemp(prefix="chip_smoke_model_")
    try:
        t0 = time.perf_counter()
        dense.save(directory)
        loaded = SpectralClustering.load(directory, device=None)
        print(f"  save + load: {time.perf_counter() - t0:.3f} s, files "
              f"{sorted(os.listdir(directory))}")
    finally:
        shutil.rmtree(directory)
    want = dense.predict(held)
    got = loaded.predict(held)
    torch.cuda.synchronize()
    route = loaded.info_["transform"]["path"]
    score = ari(truth[n:n + M_REQ], got.cpu().numpy())
    equal = bool((want == got).all())
    print(f"  predict {M_REQ} held-out points: saved and loaded labels "
          f"equal {equal}, route {route}, ARI {score:.6f}")
    if not equal or route != "fused" or score < ARI_MIN:
        fail("the loaded model does not serve like the saved one")
    return {k: f.launches for k, f in kernels.items()}


def attn_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head, positions from 0."""
    import numpy as np
    q = np.arange(S, dtype=np.int64)
    hi = np.minimum(q, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(S,
                                                                  np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def check_flash(torch, dev):
    """Phase 7: ``flash_attention`` against its plain version, and the
    path's shape timed beside ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    errs = []
    for name, B, H, KV, S, T, hd, dtype, causal, window in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((B, H, S, hd), (B, KV, T, hd),
                                 (B, KV, T, hd)))
        label = (f"flash_attention {name}: B={B} H={H} KV={KV} S={S} T={T}"
                 f" hd={hd} {dtype} causal={causal} window={window}")
        want = fa.flash_attention_plain(q, k, v, causal, window).float()
        errs.append(compare_close(torch, label, fa.flash_attention(
            q, k, v, causal, window).float(), want, *FLASH_TOL[dtype]))
        if name != "path":
            continue
        # the yardstick: one library call on the same inputs (H = KV here)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal)
        lib_err = float((sdpa().float() - want).abs().max())
        t = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal,
                                                      window), 20)
        p = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal, window), 3)
        lib = time_ms(torch, sdpa, 20)
        flops = 4 * hd * attn_pairs(S, T, causal, window) * H * B
        nbytes = q.element_size() * hd * B * (2 * H * S + 2 * KV * T)
        b, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        print(f"  timing flash_attention path: kernel {t:.4f} ms, plain "
              f"{p:.4f} ms, sdpa {lib:.4f} ms (max |sdpa - plain| "
              f"{lib_err:.3e}), bound {b:.4f} ms ({b_by}; {flops:.3e} flop "
              f"at the bf16 tensor peak, {nbytes:.3e} B)")
        row = dict(source="src/repro_torch/kernels/csrc/flash_attention.cu",
                   replaces="src/repro/kernels/flash_attention.py:83",
                   shape=f"B={B} H={H} KV={KV} S=T={S} hd={hd} {dtype} "
                         f"causal={causal}",
                   ms=t, plain_ms=p, bound_ms=b, bound_by=b_by,
                   library_ms=lib)
    row["max_abs_err"] = max(errs)
    return {"flash_attention": row}


def lm_reference(torch, np, dev):
    """Phase 8: qwen1.5's smoke config on the card (flash kernel) against
    the same weights on the CPU (plain versions), f32, prefill + 4 decode
    steps."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api, params as pp
    cfg = configs.get_smoke(LM_ARCH).with_(compute_dtype=torch.float32,
                                           use_flash_attention=True)
    cpu = api.build(cfg, "cpu")
    weights = cpu.init(torch.Generator().manual_seed(0))
    runs = {"cuda": (api.build(cfg), pp.tree_map(lambda t: t.to(dev),
                                                 weights)),
            "cpu": (cpu, weights)}
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 104))
    out = {}
    for where, (model, p) in runs.items():
        before = fa.flash_attention.launches
        t = torch.as_tensor(toks, device=model.device)
        lg, cache = model.prefill(p, {"tokens": t[:, :100]}, max_seq=104)
        steps = [lg]
        for i in range(100, 104):
            lg, cache = model.decode_step(p, cache, t[:, i:i + 1])
            steps.append(lg)
        out[where] = torch.cat(steps, dim=1).cpu()
        launched = fa.flash_attention.launches - before
        print(f"  {where}: flash_attention launches {launched}")
        if launched != (cfg.num_layers if where == "cuda" else 0):
            fail(f"the small LM on {where} launched flash_attention "
                 f"{launched} times")
    err = float((out["cuda"] - out["cpu"]).abs().max())
    scale = float(out["cpu"].abs().max())
    print(f"  {cfg.name} smoke (d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads of {cfg.hd()}, {cfg.num_layers} layers), f32, prompt 100 "
          f"+ 4 decode steps: max |card - cpu| {err:.3e} (limit "
          f"{LM_REF_TOL * scale:.3e} = {LM_REF_TOL} x max |logits| "
          f"{scale:.4f})")
    if not bool(torch.isfinite(out["cuda"]).all()) \
            or err > LM_REF_TOL * scale:
        fail("the small LM on the card disagrees with the CPU reference")


def lm_serve(torch, np, kernels):
    """Phase 9: the LM serving path at full width; returns the launch
    counts of the phase, the server and its queue."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api

    class TimedServer(serve.Server):
        """The port's Server, with each prefill and decode step timed."""

        def __init__(self, *a, **kw):
            self.prefill_ms, self.step_ms = [], []
            super().__init__(*a, **kw)

        def _prefill_slot(self, slot, req):
            t0 = time.perf_counter()
            super()._prefill_slot(slot, req)      # ends in a host read
            self.prefill_ms.append((time.perf_counter() - t0) * 1e3)

        def step(self):
            t0 = time.perf_counter()
            super().step()                        # ends in a host read
            self.step_ms.append((time.perf_counter() - t0) * 1e3)

    cfg = configs.get(LM_ARCH).with_(use_flash_attention=True)
    model = api.build(cfg)
    rng = np.random.RandomState(0)
    queue = [serve.Request(rid=i, prompt=rng.randint(
                 0, cfg.vocab_size, LM_PROMPT).astype(np.int32),
                 max_new=LM_GEN + rng.randint(0, 5))
             for i in range(LM_REQUESTS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    srv = TimedServer(model, LM_SLOTS, LM_PROMPT, LM_MAX_SEQ)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    done = srv.run(queue)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: f.launches for k, f in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.out) for r in done)
    pos = int(srv.cache["pos"])
    pm, sm = np.array(srv.prefill_ms), np.array(srv.step_ms)
    print(f"  {cfg.name}: {model.num_params()} parameters, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads of {cfg.hd()}, vocab {cfg.vocab_size}, params "
          f"{cfg.param_dtype}, compute {cfg.compute_dtype}")
    print(f"  server build (random weights + dummy prefill of "
          f"{LM_SLOTS} x {LM_PROMPT}): {t_build:.3f} s")
    print(f"  run: {len(done)} requests, {tokens} tokens, {srv.steps} decode "
          f"steps, wall {wall:.3f} s, {tokens / wall:.1f} tok/s aggregate, "
          f"final pos {pos} (max_seq {LM_MAX_SEQ})")
    print(f"  prefill ms per request (prompt {LM_PROMPT}): "
          f"{np.array2string(pm, precision=3)} (mean {pm.mean():.3f})")
    print(f"  decode ms per step ({LM_SLOTS} slots): mean {sm.mean():.3f}, "
          f"min {sm.min():.3f}, max {sm.max():.3f}")
    print(f"  peak device memory {peak / 2**30:.2f} GiB, launches {counts}")
    for r in done:
        print(f"    req {r.rid}: max_new {r.max_new}, {len(r.out)} tokens "
              f"-> {r.out[:6]}...")
    if len(done) != LM_REQUESTS or not all(
            r.done and len(r.out) == r.max_new
            and all(0 <= t < cfg.vocab_size for t in r.out) for r in done):
        fail("the server did not complete every request with its budget")
    # the reference's shared position: the dummy prompt's length plus the
    # decode steps, past max_seq when the run is long enough
    if pos != LM_PROMPT + srv.steps:
        fail(f"final pos {pos} != {LM_PROMPT} + {srv.steps} steps")
    want = cfg.num_layers * (1 + LM_REQUESTS)
    if counts["flash_attention"] != want:
        fail(f"the serving path launched flash_attention "
             f"{counts['flash_attention']} times, not {want}")
    return counts, srv, queue


def lm_routes(torch, np, srv, queue):
    """Phase 10: the kernel route against the plain route at full width in
    f32, on the served weights and the first request's prompt."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    toks = torch.as_tensor(queue[0].prompt[None].astype(np.int64),
                           device=srv.device)
    out = {}
    for flash in (True, False):
        model = api.build(srv.cfg.with_(use_flash_attention=flash,
                                        compute_dtype=torch.float32))
        before = fa.flash_attention.launches
        t0 = time.perf_counter()
        lg, cache = model.prefill(srv.params, {"tokens": toks},
                                  max_seq=LM_MAX_SEQ)
        full, _ = model.forward(srv.params, {"tokens": toks})
        torch.cuda.synchronize()
        launched = fa.flash_attention.launches - before
        print(f"  {'flash' if flash else 'dense'} route, f32: prefill + "
              f"forward of {toks.shape[1]} tokens {time.perf_counter() - t0:.3f}"
              f" s, flash_attention launches {launched}")
        if launched != (2 * srv.cfg.num_layers if flash else 0):
            fail(f"the {'flash' if flash else 'dense'} route launched "
                 f"flash_attention {launched} times")
        out[flash] = (lg, cache, full[0])
        del full
        gc.collect()
        torch.cuda.empty_cache()

    def gap(a, b):
        return float((a.float() - b.float()).abs().max()), float(
            b.float().abs().max())

    ok = True
    for what, a, b in (("prefill logits", out[True][0], out[False][0]),
                       ("KV cache k", out[True][1]["k"], out[False][1]["k"]),
                       ("KV cache v", out[True][1]["v"], out[False][1]["v"]),
                       ("forward logits", out[True][2], out[False][2])):
        err, scale = gap(a, b)
        finite = bool(torch.isfinite(a).all())
        print(f"  {what}: max |flash - dense| {err:.3e} (limit "
              f"{LM_ROUTE_TOL * scale:.3e} = {LM_ROUTE_TOL} x max |dense| "
              f"{scale:.4e}){'' if finite else ' NON-FINITE'}")
        ok = ok and finite and err <= LM_ROUTE_TOL * scale
    flash_full, dense_full = out[True][2], out[False][2]
    limit = LM_ROUTE_TOL * float(dense_full.abs().max())
    top2 = dense_full.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > limit
    same = flash_full.argmax(-1) == dense_full.argmax(-1)
    print(f"  greedy tokens: {int(same.sum())}/{same.numel()} positions "
          f"agree; {int(clear.sum())} have a top-1/top-2 margin above "
          f"{limit:.3e}, of which {int((same & clear).sum())} agree")
    if not ok or not bool(same[clear].all()):
        fail("the kernel route disagrees with the plain route")


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)   # progress survives a kill
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch import SpectralClustering, ari
    from repro_torch.core.similarity import median_sigma
    from repro_torch.data.synthetic import blobs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import (_build, block_matvec as bmv,
                                     flash_attention as fa,
                                     fused_rbf_matmat as frm,
                                     kmeans_assign as ka,
                                     rbf_similarity as rbf)

    kernels = {"fused_rbf_matmat": frm.fused_rbf_matmat,
               "fused_nystrom_matmat": frm.fused_nystrom_matmat,
               "kmeans_assign": ka.kmeans_assign,
               "rbf_similarity": rbf.rbf_similarity,
               "block_matmat": bmv.block_matmat,
               "flash_attention": fa.flash_attention}
    fused_path = ("fused_rbf_matmat", "fused_nystrom_matmat",
                  "kmeans_assign")
    card = card_line()
    print(card)
    dev = resolve_device()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    t0 = time.perf_counter()
    for lib in _build.build_all().values():
        regs = [ln.strip() for ln in open(f"{lib}.log")
                if "registers" in ln or "Compiling entry" in ln]
        print(f"built {os.path.basename(lib)}:\n    " + "\n    ".join(regs))
    print(f"build: {time.perf_counter() - t0:.1f} s")

    pts, truth = blobs(N + N_REQ * M_REQ, K, dim=D, seed=0)
    x = torch.as_tensor(pts[:N], device=dev)
    sigma = float(median_sigma(x))
    print(f"data: blobs n={N} d={D} k={K}, sigma={sigma:.6f}")

    phase("kernels vs plain")
    rows = check_kernels(torch, x, sigma, dev)

    phase("small-input reference (card vs CPU plain versions)")
    n_small = 4096
    t0 = time.perf_counter()
    card_fit = SpectralClustering(K, eigensolver="block-lanczos",
                                  seed=0).fit(pts[:n_small])
    torch.cuda.synchronize()
    print(f"  first fit of the process (n={n_small}, set-up included): "
          f"{time.perf_counter() - t0:.3f} s")
    cpu_fit = SpectralClustering(K, eigensolver="block-lanczos", seed=0,
                                 device="cpu").fit(pts[:n_small])
    ev_card = card_fit.eigenvalues_.cpu().numpy()
    ev_cpu = cpu_fit.eigenvalues_.numpy()
    ev_err = float(np.abs(ev_card - ev_cpu).max())
    agree = ari(cpu_fit.labels_.numpy(), card_fit.labels_.cpu().numpy())
    print(f"  n={n_small}: eigenvalue max diff {ev_err:.3e} (limit "
          f"{EIG_TOL}), labels ARI {agree:.6f}")
    if ev_err > EIG_TOL or agree < ARI_MIN:
        fail("card fit disagrees with the CPU reference fit")

    phase("fused main path (fit, fit, serve)")
    for fn in kernels.values():
        fn.launches = 0
    fits = {}
    for solver, n_fit in (("block-lanczos", N), ("lanczos", N_LANCZOS)):
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        est = SpectralClustering(K, affinity="fused-rbf",
                                 eigensolver=solver, assigner="lloyd",
                                 seed=0)
        est.fit(pts[:n_fit])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        labels = est.labels_.cpu().numpy()
        evals = est.eigenvalues_.cpu().numpy()
        score = ari(truth[:n_fit], labels)
        launches = {k: fn.launches - before[k] for k, fn in kernels.items()}
        print(f"  fit {solver} (n={n_fit}): wall {wall:.3f} s, phases "
              f"{ {k: round(v, 4) for k, v in est.info_['phase_s'].items()} },"
              f" matrix_passes {est.info_['engine']['matrix_passes']}, "
              f"launches {launches}")
        print(f"    eigenvalues {np.array2string(evals, precision=6)}")
        print(f"    ARI vs planted labels {score:.6f}")
        if labels.shape != (n_fit,) or not np.isfinite(evals).all():
            fail(f"fit {solver}: bad labels shape or eigenvalues")
        if score < ARI_MIN:
            fail(f"fit {solver}: ARI {score:.4f} < {ARI_MIN}")
        fits[solver] = est

    est = fits["block-lanczos"]
    before = {k: fn.launches for k, fn in kernels.items()}
    for r in range(N_REQ):
        lo = N + r * M_REQ
        t0 = time.perf_counter()
        pred = est.predict(pts[lo:lo + M_REQ])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        route = est.info_["transform"]["path"]
        score = ari(truth[lo:lo + M_REQ], pred.cpu().numpy())
        print(f"  predict request {r}: {M_REQ} points, {ms:.3f} ms, route "
              f"{route}, ARI {score:.6f}")
        if route != "fused" or score < ARI_MIN:
            fail(f"predict request {r}: route {route}, ARI {score:.4f}")
    launches = {k: fn.launches - before[k] for k, fn in kernels.items()}
    print(f"  serve launches {launches}")
    fused_counts = {k: fn.launches for k, fn in kernels.items()}
    print(f"  fused main path launches {fused_counts}")
    for k in fused_path:
        if fused_counts[k] <= 0:
            fail(f"the fused main path never launched {k}")
    del fits, est
    gc.collect()
    torch.cuda.empty_cache()

    pts, truth = blobs(N_DENSE + M_REQ, K, dim=D, seed=0)
    xd = torch.as_tensor(pts[:N_DENSE], device=dev)
    sigma_d = float(median_sigma(xd))
    print(f"data: blobs n={N_DENSE} d={D} k={K}, sigma={sigma_d:.6f}")
    phase("dense kernels vs plain")
    rows.update(check_dense_kernels(torch, xd, sigma_d, dev))
    del xd
    gc.collect()
    torch.cuda.empty_cache()

    phase("dense main path (fit dense, knn-topt, precomputed)")
    dense_counts = dense_path(torch, np, pts, truth, kernels)
    print(f"  dense main path launches {dense_counts}")
    for k in ("rbf_similarity", "block_matmat", "kmeans_assign",
              "fused_nystrom_matmat"):
        if dense_counts[k] <= 0:
            fail(f"the dense main path never launched {k}")
    del pts, truth
    gc.collect()
    torch.cuda.empty_cache()

    phase("flash_attention vs plain")
    rows.update(check_flash(torch, dev))

    phase("small LM reference (card vs CPU plain versions)")
    lm_reference(torch, np, dev)

    phase(f"LM serving path ({LM_ARCH}, full width)")
    lm_counts, srv, queue = lm_serve(torch, np, kernels)

    phase("kernel route vs plain route (full width, f32)")
    lm_routes(torch, np, srv, queue)

    counts = {k: fused_counts[k] + dense_counts[k] + lm_counts[k]
              for k in kernels}
    print(f"  main path launches, all paths {counts}")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - T_START:.1f} s")

    print(card)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", launches=counts[k], **rows[k])
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
