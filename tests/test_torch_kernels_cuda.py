"""The port's general flash, qkv3 flash, fused LayerNorm and paged
attention kernels against their plain versions, on a card.

These tests need a CUDA device and skip without one (marker ``cuda``).
They import neither jax nor paddle_tpu, so they run where the port runs:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m
cuda`` (``--noconftest``: tests/conftest.py sets up jax for the parity
tests). chip_smoke.py holds every kernel at the main paths' shapes; these
are quick checks at small shapes: the general kernels at a padded,
masked, causal shape with dropout, the qkv3 kernels with dropout, the
LayerNorm kernels with and without a residual, the paged kernel on
bf16, int8 and fp8 pools at W in {1, 4, 5}, its split page walk (rows
that live in one split, at cursor 0, parked, unreadable, a window across
two splits) at W in {1, 3, 5}, the beam's tail read through it
(`paged_tail_segment`) on bf16 and int8 pages, the qkv forward on
warpgroup products (B1 and B5, D 64 and 128, a half-full last query
block), the general kernels at head dims above 128 (sliced over D, f32
and bf16), the paged kernel at head dims 80 and 16 and page sizes 4 and
3, the general bf16 kernels
at the edges of their tiles, B1's backward against the general
backward on the unpacked views (the kernel they share), and the paged
Engine's captured decode step at the serving decode shape: its CUDA
graph's replay against its eager run, bit for bit, and the launch counts
its replays add; the multi-tensor Adam kernel against its plain version,
and a small GPT's captured train step against its eager twin.
"""
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as pfa


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_the_plain_versions_on_a_card(dtype):
    """The kernels against their plain versions at a masked, padded,
    causal shape with dropout: f32 at 1e-4 (summation order), bf16 at
    2e-2 (a few bf16 ulps of values of order 1); each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((2, 200, 3, 64), generator=g, device="cuda")
                   .to(dt) for _ in range(4))
    mask = torch.rand((2, 1, 200, 200), generator=g, device="cuda") > 0.3
    kw = dict(bias=pfa.normalize_mask_bias(mask), dropout_p=0.1,
              seed=torch.tensor([7], dtype=torch.int32, device="cuda"))
    kernels.reset_kernel_launch_counts()
    o, lse = pfa.flash_attention_fwd(q, k, v, True, **kw)
    ro, rlse = pfa.flash_reference(q, k, v, True, **kw)
    grads = pfa.flash_attention_bwd(q, k, v, ro, rlse, do, True, **kw)
    rgrads = pfa.flash_bwd_reference(q, k, v, ro, rlse, do, True, **kw)
    tol = dict(atol=1e-4, rtol=0) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    for a, r in zip((o, *grads), (ro, *rgrads)):
        torch.testing.assert_close(a.float(), r.float(), **tol)
    counts = kernels.kernel_launch_counts()
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv3_kernels_match_the_plain_versions_on_a_card(dtype):
    """The which-major qkv3 kernels (B5) against their plain versions with
    dropout, f32 at 1e-4, bf16 at 2e-2, and against B1 on the repacked
    projection (same kernels, other column offsets): bit for bit but
    bf16 dq, which is held within 8 bf16 ulps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    h, d = 4, 64
    qkv = torch.randn((2, 256, 3 * h * d), generator=g, device="cuda").to(dt)
    do = torch.randn((2, 256, h * d), generator=g, device="cuda").to(dt)
    seed = torch.tensor([9], dtype=torch.int32, device="cuda")
    kernels.reset_kernel_launch_counts()
    o, lse = pfa.flash_attention_qkv3_fwd(qkv, h, False, 0.1, seed)
    ro, rlse = pfa.flash_qkv3_reference(qkv, h, False, 0.1, seed)
    dqkv = pfa.flash_attention_qkv3_bwd(qkv, do, ro, rlse, h, False, 0.1,
                                        seed)
    rdqkv = pfa.flash_qkv3_bwd_reference(qkv, do, ro, rlse, h, False, 0.1,
                                         seed)
    tol = dict(atol=1e-4, rtol=0) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    for a, r in ((o, ro), (dqkv, rdqkv)):
        torch.testing.assert_close(a.float(), r.float(), **tol)
    pair = pfa._which_to_pair(qkv, h).contiguous()
    o1, lse1 = pfa.flash_attention_qkv_fwd(pair, h, False, 0.1, seed)
    d1 = pfa.flash_attention_qkv_bwd(pair, do, ro, rlse, h, False, 0.1, seed)
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
    mq, mk, mv = dqkv.split(h * d, dim=-1)
    tq, tk, tv = pfa._pair_to_which(d1, h).split(h * d, dim=-1)
    assert torch.equal(mk, tk) and torch.equal(mv, tv)
    # bf16 dq sums its key blocks by atomics in an order that varies
    assert torch.equal(mq, tq) if dtype == "float32" else _ulps(mq, tq, d) <= 8
    counts = kernels.kernel_launch_counts()
    assert counts["flash_attention_qkv3_fwd"] == 1
    assert counts["flash_attention_qkv3_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False])
def test_fused_ln_kernels_match_the_plain_versions_on_a_card(dtype,
                                                             residual):
    """The fused LayerNorm kernels (B6) against their plain versions: y
    and dx at 1e-4 (f32) or 2e-2 (bf16: values of order 1 rounded to
    bf16), mean and rstd at 1e-4, dg and db (sums over 256 rows) at
    1e-3 relative; each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    from paddle_tpu_torch.kernels import fused_ln as pfl

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    x, r, dy = (torch.randn((256, 384), generator=g, device="cuda").to(dt)
                for _ in range(3))
    w, b = (torch.randn(384, generator=g, device="cuda") for _ in range(2))
    r = r if residual else None
    kernels.reset_kernel_launch_counts()
    y, mean, rstd = pfl.fused_ln_fwd(x, r, w, b, 1e-5)
    ry, rmean, rrstd = pfl.fused_ln_reference(x, r, w, b, 1e-5)
    dx, dg, db = pfl.fused_ln_bwd(x, r, w, rmean, rrstd, dy)
    rdx, rdg, rdb = pfl.fused_ln_bwd_reference(x, r, w, rmean, rrstd, dy)
    tol = dict(atol=1e-4, rtol=0) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    for a, ref in ((y, ry), (dx, rdx)):
        torch.testing.assert_close(a.float(), ref.float(), **tol)
    for a, ref in ((mean, rmean), (rstd, rrstd)):
        torch.testing.assert_close(a, ref, atol=1e-4, rtol=0)
    for a, ref in ((dg, rdg), (db, rdb)):
        torch.testing.assert_close(a, ref, atol=1e-3, rtol=1e-3)
    counts = kernels.kernel_launch_counts()
    assert counts["fused_ln_fwd"] == counts["fused_ln_bwd"] == 1


@pytest.mark.cuda
def test_fused_ln_wrappers_refuse_an_unaligned_weight():
    """The kernels read g and b as 16-byte vectors: a float32 weight
    view at an unaligned offset is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    from paddle_tpu_torch.kernels import fused_ln as pfl

    x = torch.randn((128, 128), device="cuda")
    w = torch.ones(129, device="cuda")[1:]
    b = torch.zeros(128, device="cuda")
    kernels.reset_kernel_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        pfl.fused_ln_fwd(x, None, w, b, 1e-5)
    mean = rstd = torch.ones(128, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        pfl.fused_ln_bwd(x, None, w, mean, rstd, x)
    assert kernels.kernel_launch_counts()["fused_ln_fwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("w", [1, 4, 5])
def test_paged_kernel_matches_the_plain_version_on_a_card(pages, w):
    """The paged-attention kernel on float and quantized (int8, fp8 e4m3
    with f32 scales) pools, bf16 queries, at W in {1, 4, 5} (a 5-query
    verify window takes one 8-query tile), against its plain version:
    out at 2e-2 (bf16 rounding of values of order 1; both dequantize in
    f32), lse at 1e-3; rows with left pads, a row with no readable
    column, a row parked on the sentinel; each launch counted under its
    pool's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import paged_kv

    g = torch.Generator(device="cuda").manual_seed(w)
    n, h, d, ps, pmax = 4, 4, 128, 16, 6
    pools = [torch.randn((n * pmax + 1, h, ps, d), generator=g,
                         device="cuda") for _ in range(2)]
    scales = None
    if pages == "bfloat16":
        pools = [p.to(torch.bfloat16) for p in pools]
    else:
        dt = torch.int8 if pages == "int8" else torch.float8_e4m3fn
        pools, scales = zip(*(paged_kv.quantize_tokens(p, dt) for p in pools))
    bt = torch.randperm(n * pmax, generator=g, device="cuda").reshape(
        n, pmax).to(torch.int32)
    steps = torch.tensor([40, 70, 3, 0], dtype=torch.int32, device="cuda")
    vc = torch.ones((n, pmax * ps), dtype=torch.int32, device="cuda")
    vc[0, :20] = 0                               # left pads: page 0 skipped
    vc[1] = 0                                    # no readable column
    bt[3], vc[3] = n * pmax, 0                   # parked on the sentinel
    q = torch.randn((n, h, w, d), generator=g, device="cuda").to(
        torch.bfloat16)
    args = (q, *pools, bt, steps, vc)
    kw = {} if scales is None else dict(k_scale=scales[0], v_scale=scales[1])
    kernels.reset_kernel_launch_counts()
    out, lse = pa.fused_paged_attention(*args, **kw)
    ref, ref_lse = pa.paged_attention_reference(*args, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    name = {"bfloat16": "paged_attention", "int8": "paged_attention_int8",
            "fp8": "paged_attention_fp8"}[pages]
    counts = kernels.kernel_launch_counts()
    assert counts[name] == 1
    assert sum(v for k, v in counts.items() if k.startswith("paged")) == 1


@pytest.mark.cuda
def test_paged_wrapper_refuses_quantized_pools_without_scales():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    from paddle_tpu_torch.kernels import paged_attention as pa

    q = torch.zeros((1, 1, 1, 64), device="cuda")
    pool = torch.zeros((2, 1, 8, 64), dtype=torch.int8, device="cuda")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    st = torch.zeros((1,), dtype=torch.int32, device="cuda")
    vc = torch.ones((1, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="need k_scale"):
        pa.fused_paged_attention(q, pool, pool, bt, st, vc)
    fpool = torch.zeros((2, 1, 8, 64), device="cuda")
    sc = torch.zeros((2, 1, 8), device="cuda")
    with pytest.raises(ValueError, match="scales were passed"):
        pa.fused_paged_attention(q, fpool, fpool, bt, st, vc, sc, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
@pytest.mark.parametrize("gen_col", [0, 7, 16, 47])
def test_paged_tail_segment_matches_the_plain_version_on_a_card(pages,
                                                               gen_col):
    """The beam's tail read through the paged kernel (W = 1, every row at
    gen column ``gen_col``, all columns valid) against the same
    dispatcher on CPU copies of its inputs (its plain version): out at
    2e-2, lse at 1e-3, on bf16 and int8 pages; gen column 0 is a tail of
    one column. Each launch counts once under ``paged_tail_segment`` and
    once under the pool's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import paged_kv

    g = torch.Generator(device="cuda").manual_seed(gen_col)
    n, h, d, ps, pg = 8, 4, 128, 16, 3
    pools = [torch.randn((n * pg, h, ps, d), generator=g, device="cuda")
             for _ in range(2)]
    kw = {}
    if pages == "bfloat16":
        pools = [p.to(torch.bfloat16) for p in pools]
    else:
        pools, scales = zip(*(paged_kv.quantize_tokens(p, torch.int8)
                              for p in pools))
        kw = dict(k_scale=scales[0], v_scale=scales[1])
    bt = torch.randperm(n * pg, generator=g, device="cuda").reshape(
        n, pg).to(torch.int32)
    q = torch.randn((n, h, d), generator=g, device="cuda").to(torch.bfloat16)
    kernels.reset_kernel_launch_counts()
    out, lse = pa.paged_tail_segment(q, *pools, bt, gen_col, d, **kw)
    counts = kernels.kernel_launch_counts()
    ref, ref_lse = pa.paged_tail_segment(
        q.cpu(), *(p.cpu() for p in pools), bt.cpu(), gen_col, d,
        **{k: v.cpu() for k, v in kw.items()})
    assert out.shape == (n, h, d) and lse.shape == (n, h)
    torch.testing.assert_close(out.float().cpu(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse.cpu(), ref_lse, atol=1e-3, rtol=0)
    name = "paged_attention" if pages == "bfloat16" else \
        "paged_attention_int8"
    assert counts["paged_tail_segment"] == counts[name] == 1
    assert sum(v for k, v in counts.items() if k.startswith("paged")) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("w", [1, 3, 5])
def test_paged_split_walk_matches_the_plain_version_on_a_card(pages, w):
    """The split page walk (`plan_splits` cuts this table into 2-page
    splits) against the plain version: a row readable only in its first
    split, a row at cursor 0, a row parked on the sentinel, a row with
    no readable column, a row whose last query alone reads (its own
    cursor column), a window straddling splits 0 and 1; f32 queries and
    pages at 1e-4, bf16 queries at 2e-2 (out) and 1e-3 (lse). Two calls
    in a row agree bit for bit: the combine's tickets are back at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import paged_kv

    g = torch.Generator(device="cuda").manual_seed(10 + w)
    n, h, d, ps, pmax = 6, 2, 64, 16, 12
    qdt = torch.float32 if pages == "float32" else torch.bfloat16
    pools = [torch.randn((n * pmax + 1, h, ps, d), generator=g,
                         device="cuda") for _ in range(2)]
    kw = {}
    if pages in ("float32", "bfloat16"):
        pools = [p.to(qdt) for p in pools]
    else:
        dt = torch.int8 if pages == "int8" else torch.float8_e4m3fn
        pools, scales = zip(*(paged_kv.quantize_tokens(p, dt) for p in pools))
        kw = dict(k_scale=scales[0], v_scale=scales[1])
    splits, pps = pa.plan_splits(n, h, w, pmax, ps,
                                 torch.cuda.get_device_properties(0)
                                 .multi_processor_count, d)
    assert splits > 2
    lp = pmax * ps
    bt = torch.randperm(n * pmax, generator=g, device="cuda").reshape(
        n, pmax).to(torch.int32)
    edge = pps * ps                          # first column of split 1
    steps = torch.tensor([lp - w, 0, 0, lp - w, 100, edge - 2],
                         dtype=torch.int32, device="cuda")
    vc = torch.ones((n, lp), dtype=torch.int32, device="cuda")
    vc[0, edge:] = 0
    bt[2], vc[2] = n * pmax, 0
    vc[3] = 0
    vc[4] = 0
    vc[4, 100 + w - 1] = 1
    q = torch.randn((n, h, w, d), generator=g, device="cuda").to(qdt)
    args = (q, *pools, bt, steps, vc)
    out, lse = pa.fused_paged_attention(*args, **kw)
    again, lse2 = pa.fused_paged_attention(*args, **kw)
    ref, ref_lse = pa.paged_attention_reference(*args, **kw)
    tol_o = dict(atol=1e-4, rtol=0) if qdt == torch.float32 else \
        dict(atol=2e-2, rtol=2e-2)
    tol_l = dict(atol=1e-4, rtol=0) if qdt == torch.float32 else \
        dict(atol=1e-3, rtol=0)
    torch.testing.assert_close(out.float(), ref.float(), **tol_o)
    torch.testing.assert_close(lse, ref_lse, **tol_l)
    assert torch.equal(out, again) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 320])
def test_qkv_forward_on_wgmma_matches_the_plain_version(d, causal, s):
    """B1's and B5's bf16 forward (warpgroup products on TMA-loaded
    tiles) against the plain version with dropout 0.1: o at 2e-2, lse at
    1e-4; S = 320 leaves the last 128-query block half full. B5 equals
    B1 on the repacked projection bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    g = torch.Generator(device="cuda").manual_seed(d + s)
    h = 4
    qkv = torch.randn((2, s, 3 * h * d), generator=g, device="cuda").to(
        torch.bfloat16)
    seed = torch.tensor([11], dtype=torch.int32, device="cuda")
    o, lse = pfa.flash_attention_qkv_fwd(qkv, h, causal, 0.1, seed)
    ro, rlse = pfa.flash_qkv_reference(qkv, h, causal, 0.1, seed)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    which = pfa._pair_to_which(qkv, h).contiguous()
    o3, lse3 = pfa.flash_attention_qkv3_fwd(which, h, causal, 0.1, seed)
    assert torch.equal(o3, o) and torch.equal(lse3, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [192, 256, 384])
def test_flash_attention_above_head_dim_128_matches_the_plain_version(dtype,
                                                                      d):
    """Heads above 128 on a card (bf16 at 192 and 256: the wgmma
    kernels on 64-key tiles and blocks; bf16 at 384 and f32 at every D:
    the kernels sliced over D), forward and backward, against their
    plain versions at a key-padded causal shape with dropout (Sq != Sk,
    lengths not multiples of 64): f32 at 1e-4 (summation order), bf16 o,
    dq, dk and dv within 8 bf16 ulps of each element's scale, lse at
    1e-4; each launch counted once. Through `flash_attention` the grads
    reach q, k and v at their own width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(d)
    b, s_q, s_k, h = 2, 136, 200, 2
    q, do = (torch.randn((b, s_q, h, d), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((b, s_k, h, d), generator=g, device="cuda").to(dt)
            for _ in range(2))
    lens = torch.tensor([s_k, s_k - 77], device="cuda")
    mask = torch.arange(s_k, device="cuda")[None] < lens[:, None]
    kw = dict(bias=pfa.normalize_mask_bias(mask[:, None, None, :]),
              dropout_p=0.1,
              seed=torch.tensor([5], dtype=torch.int32, device="cuda"))
    kernels.reset_kernel_launch_counts()
    o, lse = pfa.flash_attention_fwd(q, k, v, True, **kw)
    ro, rlse = pfa.flash_reference(q, k, v, True, **kw)
    grads = pfa.flash_attention_bwd(q, k, v, ro, rlse, do, True, **kw)
    rgrads = pfa.flash_bwd_reference(q, k, v, ro, rlse, do, True, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    for part, x, ref in zip(("o", "dq", "dk", "dv"), (o, *grads),
                            (ro, *rgrads)):
        if dtype == "float32":
            torch.testing.assert_close(x, ref, atol=1e-4, rtol=0)
        else:
            assert _ulps(x, ref, d) <= 8, part
    counts = kernels.kernel_launch_counts()
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 1
    x = q.detach().requires_grad_()
    pfa.flash_attention(x, x, x, attn_mask=mask[:, None, None, :s_q]
                        ).float().sum().backward()
    assert x.grad.shape == x.shape and torch.isfinite(x.grad.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
@pytest.mark.parametrize("d,ps", [(80, 4), (80, 3), (16, 4), (80, 16)])
@pytest.mark.parametrize("w", [1, 5])
def test_paged_kernel_at_any_head_dim_and_page_size_on_a_card(pages, d, ps,
                                                               w):
    """The paged kernel at head dims that are not 64 or 128 (gpt3-2.7b's
    80, gpt-test's 16) and page sizes that are not multiples of 8 (its
    ring chunks then end inside a page), on bf16 and int8 pools kept at
    the model's D, against its plain version (out at 2e-2, lse at 1e-3),
    with a row of left pads, a row with no readable column and a row
    parked on the sentinel; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import paged_kv

    g = torch.Generator(device="cuda").manual_seed(d * ps + w)
    n, h, pmax = 4, 4, 11
    pools = [torch.randn((n * pmax + 1, h, ps, d), generator=g,
                         device="cuda") for _ in range(2)]
    scales = None
    if pages == "bfloat16":
        pools = [p.to(torch.bfloat16) for p in pools]
    else:
        pools, scales = zip(*(paged_kv.quantize_tokens(p, torch.int8)
                              for p in pools))
    bt = torch.randperm(n * pmax, generator=g, device="cuda").reshape(
        n, pmax).to(torch.int32)
    lp = pmax * ps
    steps = torch.tensor([lp - w, lp // 2, 3, 0], dtype=torch.int32,
                         device="cuda")
    vc = torch.ones((n, lp), dtype=torch.int32, device="cuda")
    vc[0, :ps + 1] = 0                           # left pads past a page
    vc[1] = 0                                    # no readable column
    bt[3], vc[3] = n * pmax, 0                   # parked on the sentinel
    q = torch.randn((n, h, w, d), generator=g, device="cuda").to(
        torch.bfloat16)
    args = (q, *pools, bt, steps, vc)
    kw = {} if scales is None else dict(k_scale=scales[0], v_scale=scales[1])
    kernels.reset_kernel_launch_counts()
    out, lse = pa.fused_paged_attention(*args, **kw)
    ref, ref_lse = pa.paged_attention_reference(*args, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert sum(v for k, v in kernels.kernel_launch_counts().items()
               if k.startswith("paged")) == 1


def _ulps(x, ref, d):
    """``|x - ref|`` of each element in bf16 ulps (2^-8) of its scale: the
    largest of its own ``|ref|``, its row's rms (one head's ``d`` values
    at one position) and 1/64 of the tensor's rms; chip_smoke.py's
    ``flash_ulps`` rule."""
    r = ref.float().reshape(-1, d)
    scale = torch.maximum(r.abs(),
                          r.square().mean(dim=1, keepdim=True).sqrt())
    scale = scale.clamp(min=r.square().mean().sqrt().item() / 64)
    return ((x.float().reshape(-1, d) - r).abs()
            / (scale * 2.0 ** -8)).max().item()


# name: (b, s_q, s_k, h, d, causal, bias kind, dropout)
B2_EDGES = {
    "sq_ne_sk_causal": (2, 128, 384, 4, 64, True, None, 0.1),
    "sk200_key_padding": (2, 200, 200, 4, 64, False, "key_padding", 0.1),
    "s320_d128_causal": (2, 320, 320, 4, 128, True, None, 0.1),
    "full_bias": (2, 256, 320, 4, 64, False, "full", 0.0),
    "fully_masked_row_d128": (2, 200, 200, 3, 128, False, "dead_row", 0.0),
    "d128_dropout": (2, 256, 256, 4, 128, False, "key_padding", 0.1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(B2_EDGES))
def test_general_bf16_kernels_at_their_edges_on_a_card(name):
    """B2's bf16 forward (TMA/wgmma) and one-pass backward against the
    plain versions at the edges of their tiles: Sq != Sk causal, lengths
    that are not multiples of 128, D=128 with and without dropout, a
    full [B, Sq, Sk] bias, a fully masked row. lse at 1e-4; o, dq, dk
    and dv within 8 bf16 ulps of each element's scale (chip_smoke.py's
    rule); the backward gets the plain forward's o and lse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    b, s_q, s_k, h, d, causal, kind, p = B2_EDGES[name]
    g = torch.Generator(device="cuda").manual_seed(len(name))
    q, do = (torch.randn((b, s_q, h, d), generator=g, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, s_k, h, d), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    bias = None
    if kind == "key_padding":
        lens = torch.randint(s_k // 2, s_k + 1, (b,), generator=g,
                             device="cuda")
        mask = torch.arange(s_k, device="cuda")[None] < lens[:, None]
        bias = pfa.normalize_mask_bias(mask[:, None, None, :])
    elif kind == "full":
        bias = torch.randn((b, s_q, s_k), generator=g, device="cuda") * 2
    elif kind == "dead_row":
        mask = torch.ones((b, 1, s_q, s_k), dtype=torch.bool, device="cuda")
        mask[1, 0, 7] = False
        bias = pfa.normalize_mask_bias(mask)
    kw = dict(bias=bias, dropout_p=p,
              seed=torch.tensor([31], dtype=torch.int32, device="cuda"))
    o, lse = pfa.flash_attention_fwd(q, k, v, causal, **kw)
    ro, rlse = pfa.flash_reference(q, k, v, causal, **kw)
    grads = pfa.flash_attention_bwd(q, k, v, ro, rlse, do, causal, **kw)
    rgrads = pfa.flash_bwd_reference(q, k, v, ro, rlse, do, causal, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    for part, x, ref in zip(("o", "dq", "dk", "dv"), (o, *grads),
                            (ro, *rgrads)):
        assert _ulps(x, ref, d) <= 8, part


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_qkv_backward_is_the_general_backward_on_a_card(dtype, d, causal):
    """B1's backward on the pair-major projection and B2's
    (`flash_attention_bwd`) on its three unpacked views, at p=0 with the
    plain forward's o and lse: one kernel read through another column
    rule, so dk and dv agree bit for bit, and dq too in float32; bf16 dq
    sums its key blocks by atomics in an order that varies, so it is held
    within 8 bf16 ulps of each element's scale (chip_smoke.py's rule).
    S = 320 leaves the last 128-key block half full."""
    from paddle_tpu_torch.models.gpt import unpack_qkv_pair_major

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(d + int(causal))
    b, s, h = 2, 320, 4
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda").to(dt)
    do = torch.randn((b, s, h * d), generator=g, device="cuda").to(dt)
    o, lse = pfa.flash_qkv_reference(qkv, h, causal)
    dqkv = pfa.flash_attention_qkv_bwd(qkv, do, o, lse, h, causal)
    views = [t.contiguous() for t in unpack_qkv_pair_major(qkv, h, d)]
    dq, dk, dv = pfa.flash_attention_bwd(*views, o.reshape(b, s, h, d), lse,
                                         do.reshape(b, s, h, d), causal)
    mq, mk, mv = unpack_qkv_pair_major(dqkv, h, d)
    assert torch.equal(mk, dk) and torch.equal(mv, dv)
    if dtype == "float32":
        assert torch.equal(mq, dq)
    else:
        assert _ulps(mq, dq, d) <= 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_lse_kernels_match_the_plain_versions_on_a_card(dtype,
                                                              causal):
    """B4 (`flash_attention_with_lse`) at a head_dim it pads (48): o, lse
    and the grads of a loss reading both (a nonzero lse cotangent)
    against the plain versions, f32 at 1e-4, bf16 within 8 ulps of each
    element's scale; one launch each way, counted as B4's, none as B2's;
    with a zero lse cotangent B4's backward is B2's (dk, dv bit for
    bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn((2, 256, 3, 48), generator=g, device="cuda")
               .to(dt).requires_grad_(True) for _ in range(3))
    kernels.reset_kernel_launch_counts()
    o, lse = kernels.flash_attention_with_lse(q, k, v, is_causal=causal)
    (o.float().sin().sum() + lse.cos().sum()).backward()
    counts = kernels.kernel_launch_counts()
    assert counts["flash_attention_lse_fwd"] == 1
    assert counts["flash_attention_lse_bwd"] == 1
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 0
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ro, rlse = pfa._FlashLse.apply(*(t.cpu() for t in leaves), causal,
                                   48 ** -0.5)
    (ro.float().sin().sum() + rlse.cos().sum()).backward()
    torch.testing.assert_close(lse.cpu(), rlse, atol=1e-4, rtol=0)
    for a, r in zip((o, q.grad, k.grad, v.grad),
                    (ro, *(t.grad for t in leaves))):
        if dtype == "float32":
            torch.testing.assert_close(a.cpu(), r.cpu(), atol=1e-4, rtol=0)
        else:
            assert _ulps(a.cpu(), r.cpu(), 48) <= 8
    qp, kp, vp = (torch.nn.functional.pad(t.detach(), (0, 16))
                  for t in (q, k, v))
    po, plse = pfa.flash_attention_lse_fwd(qp, kp, vp, causal, 48 ** -0.5)
    do = torch.randn(po.shape, generator=g, device="cuda").to(dt)
    zero = pfa.flash_attention_lse_bwd(qp, kp, vp, po, plse, do,
                                       torch.zeros_like(plse), causal,
                                       48 ** -0.5)
    b2 = pfa.flash_attention_bwd(qp, kp, vp, po, plse, do, causal,
                                 scale=48 ** -0.5)
    assert torch.equal(zero[1], b2[1]) and torch.equal(zero[2], b2[2])


def _decode_engine(pages):
    """An engine at gpt3-1.3b's serving widths (hidden 2048, 16 heads of
    128, MLP 8192, vocab 50304) cut to 2 layers, bf16, every one of its 8
    slots holding a prompt, after one step (its graphs captured)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import Engine

    cfg = GPTConfig(50304, 2048, 2, 16, 8192, 2048)
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=0)
    eng = Engine(model, slots=8, page_size=16, max_len=640,
                 prefill_buckets=(128, 512), kv_quant=pages)
    g = torch.Generator().manual_seed(0)
    for n in (20, 75, 130, 190, 250, 310, 370, 430):
        eng.submit(torch.randint(1, 50304, (n,), generator=g).tolist(),
                   max_new_tokens=16)
    eng.step()
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("pages", [None, "int8"])
def test_decode_step_replay_equals_its_eager_run_on_a_card(pages):
    """The engine's captured decode step at the serving decode shape:
    one replay and one eager run of its body on the same staged operands,
    each from the same pools (cloned before, restored between), give the
    same float32 logits, bit for bit, at three decode steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured and "
                    "replayed only on the card")
    eng = _decode_engine(pages)
    fn = eng._verify
    assert eng.stats().decode_traces == 1
    for _ in range(3):
        ops = eng._step_operands(eng._tokens[:, None])
        with torch.inference_mode():
            saved = [t.clone() for t in fn.fixed]
            graph = fn(**ops)
            for t, v in zip(fn.fixed, saved):
                t.copy_(v)
            eager = fn.run_eager(**ops)
            for t, v in zip(fn.fixed, saved):
                t.copy_(v)
        assert torch.equal(graph, eager)
        eng.step()


@pytest.mark.cuda
@pytest.mark.parametrize("pages", [None, "int8"])
def test_launch_counts_under_replay_on_a_card(pages):
    """Each replay of the captured decode step adds the paged kernel's
    launches of its capture (one a layer); the warm-up and the capture
    leave the counts as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured and "
                    "replayed only on the card")
    eng = _decode_engine(pages)
    name = "paged_attention" + ("_" + pages if pages else "")
    assert eng._verify._delta == {name: 2}
    kernels.reset_kernel_launch_counts()
    before = eng.stats().decode_steps
    for _ in range(4):
        eng.step()
    steps = eng.stats().decode_steps - before
    counts = kernels.kernel_launch_counts()
    assert steps == 4 and counts[name] == steps * 2
    assert all(v == 0 for k, v in counts.items() if k != name)
    assert eng.stats().decode_traces == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("bfloat16",) * 3, ("float32",) * 3,
                                    ("bfloat16", "bfloat16", "float32")],
                         ids=lambda d: "-".join(d))
@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "adam_l2"])
def test_multi_tensor_adam_matches_its_plain_version_on_a_card(dtypes,
                                                               adamw):
    """The multi-tensor Adam kernel against `adam_reference` over tensors
    of awkward sizes (a partial last vector, one of 5 elements, a grad
    that is not contiguous) with a clip scale: every stored element bit
    for bit (both round the same
    float32 operations once); one launch a dtype group; a found-inf flag
    writes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta

    pdt, gdt, sdt = (getattr(torch, d) for d in dtypes)
    g = torch.Generator(device="cuda").manual_seed(3)

    def entries():
        g.manual_seed(3)
        out = []
        for shape in ((1000, 3), (70001,), (5,)):
            p = torch.randn(shape, generator=g, device="cuda").to(pdt)
            grad = torch.randn(shape, generator=g, device="cuda") * 1e-2
            if len(shape) == 2:      # a grad that is a transposed view
                grad = grad.t().contiguous().t()
            out.append(mta.AdamEntry(
                p, grad.to(gdt), (0.1 * grad).to(sdt),
                (1e-3 * grad * grad).to(sdt), None, 0.1))
        return out

    a, b = entries(), entries()
    lr = torch.tensor(1e-3, device="cuda")
    step = torch.tensor(4, dtype=torch.int32, device="cuda")
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, adamw=adamw,
              clip_scale=torch.tensor(0.5, device="cuda"))
    kernels.reset_kernel_launch_counts()
    mta.multi_tensor_adam(a, lr, step, tables=mta.AdamTables(), **kw)
    mta.adam_reference(b, lr, step, **kw)
    assert kernels.kernel_launch_counts()["multi_tensor_adam"] == 1
    for x, y in zip(a, b):
        for s, t in zip(x[:4], y[:4]):
            assert torch.equal(s, t)
    c = entries()
    mta.multi_tensor_adam(c, lr, step, tables=mta.AdamTables(),
                          found_inf=torch.ones((), dtype=torch.int32,
                                               device="cuda"), **kw)
    for x, y in zip(c, entries()):
        for s, t in zip(x[:4], y[:4]):
            assert torch.equal(s, t)


@pytest.mark.cuda
def test_train_step_replay_equals_its_eager_run_on_a_card():
    """`SpmdTrainStep` on a small GPT with dropout, bf16: its first call
    builds one graph; replays from one state and key equal the eager
    twin (`run_eager`) bit for bit, loss and params; each replay counts
    the update's and the flash kernels' launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured and "
                    "replayed only on the card")
    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(256, 128, 2, 2, 256, 128)
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=0)
    model.train()
    step = SpmdTrainStep(model, gpt_loss_fn, AdamW(learning_rate=1e-3))
    params, state = step.init(slot_dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, 256, (4, 129), generator=g, device="cuda")
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    step(params, state, batch, 0)
    flat = list(params.values()) + [state["step"]] + [
        s for n in sorted(state["slots"]) for s in state["slots"][n].values()]
    saved = [t.clone() for t in flat]
    kernels.reset_kernel_launch_counts()
    graph = step(params, state, batch, 7)[0]
    counts = kernels.kernel_launch_counts()
    after = [t.clone() for t in flat]
    for t, v in zip(flat, saved):
        t.copy_(v)
    eager = step.run_eager(params, state, batch, 7)[0]
    assert torch.equal(graph, eager)
    assert all(torch.equal(a, t) for a, t in zip(after, flat))
    assert counts["multi_tensor_adam"] == 1
    assert counts["flash_attention_qkv_fwd"] == 2
    assert step.metrics_snapshot()["xla_traces"] == 1
