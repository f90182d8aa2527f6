"""The split page walk of the port's paged-attention kernel, on the CPU.

The Hopper kernel (csrc/paged_attention.cu) splits each row's page walk
across blocks and merges the splits' partials in the same launch. Two
things of that design are plain Python and are pinned here:

- `plan_splits`, the wrapper's choice of (splits, pages a split): a pure
  function of the shapes and the SM count, which covers the table
  exactly and fills the card at the engine's and the beam tail's shapes;
- the walk and merge rule that the CUDA code follows, written out below
  (`split_and_combine`): each split walks its live pages (or, when the
  tile's first query has no readable column in the row, all of its
  pages), four warps take them round robin in `chunk_cols`-column chunks with
  their own online softmax, the warps merge, then the splits merge with
  M = max m and weights exp(m - M). It is held against
  `paged_attention_reference` and paddle_tpu's Pallas kernel in
  interpret mode, in float32 at atol 2e-5 (summation order), on ragged
  rows, a fully masked row, a parked row and a W=3 tile where only the
  last query has a readable column.

The kernel itself runs only on a card: tests/test_torch_kernels_cuda.py
and chip_smoke.py hold it against the same plain version there.
"""
import dis
import math

import numpy as np
import pytest
import torch

import paddle_tpu.kernels.paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels.paged_kv import gather_pages

ATOL = 2e-5
MASKED = -1e30
WARPS = 4                  # warps of a block, as in the kernel
H100_SMS = 132


@pytest.fixture
def interpret_kernel():
    jpa._INTERPRET = True
    try:
        yield
    finally:
        jpa._INTERPRET = False


# ------------------------------------------------------------- the planner
SHAPES = [  # (N, H, W, Pmax, ps)
    (8, 16, 1, 40, 16),    # the engine's decode step
    (8, 16, 5, 40, 16),    # its k=4 verify window
    (32, 16, 1, 8, 16),    # the beam tail: 8 rows x 4 beams, Pg = 8
    (6, 8, 4, 8, 32), (1, 1, 1, 1, 8), (3, 2, 8, 7, 8), (64, 32, 1, 200, 16),
    (2, 4, 3, 129, 16), (1, 16, 1, 2048, 16),
]


@pytest.mark.parametrize("n,h,w,pmax,ps", SHAPES)
@pytest.mark.parametrize("sms", [1, 78, H100_SMS])
def test_every_page_falls_in_exactly_one_split(n, h, w, pmax, ps, sms):
    splits, pps = pa.plan_splits(n, h, w, pmax, ps, sms, 128)
    assert splits >= 1 and pps >= 1
    owner = [p // pps for p in range(pmax)]
    assert set(owner) == set(range(splits))           # no empty split
    ranges = [range(s * pps, min((s + 1) * pps, pmax))
              for s in range(splits)]
    assert sorted(p for r in ranges for p in r) == list(range(pmax))


@pytest.mark.parametrize("n,h,w,pmax,ps", [SHAPES[0], SHAPES[1], SHAPES[2]])
def test_engine_and_tail_shapes_fill_the_card(n, h, w, pmax, ps):
    splits, _ = pa.plan_splits(n, h, w, pmax, ps, H100_SMS, 128)
    tiles = -(-w // pa.query_tile(w, 128))
    assert n * h * tiles * splits >= 2 * H100_SMS
    assert splits >= 2


def test_planner_reads_no_tensor():
    """The split count comes from ints alone: the planner's code names
    nothing of torch, and it runs on plain ints (a read of steps or
    valid_cols would wait for the card every decode step)."""
    names = {i.argval for i in dis.get_instructions(pa.plan_splits)}
    assert not names & {"torch", "item", "tolist", "cpu", "numpy"}
    assert pa.plan_splits(8, 16, 1, 40, 16, H100_SMS, 128) == (5, 8)
    assert pa.plan_splits(32, 16, 1, 8, 16, H100_SMS, 128) == (2, 4)


# ------------------------------------------------------ the walk and merge
def _merge(ms, ls, os_):
    """The kernel's merge of partial (m, l, o) states, f32."""
    ms, ls, os_ = torch.stack(ms), torch.stack(ls), torch.stack(os_)
    mx = ms.amax(dim=0)
    e = torch.exp(ms - mx)
    return mx, (e * ls).sum(0), (e[..., None] * os_).sum(0)


def split_and_combine(q, pool_k, pool_v, bt, steps, vc, sms=H100_SMS):
    """What csrc/paged_attention.cu computes, step by step, in f32."""
    n, h, w, d = q.shape
    ps = pool_k.shape[2]
    pmax = bt.shape[1]
    tile = pa.query_tile(w, d)
    splits, pps = pa.plan_splits(n, h, w, pmax, ps, sms, d)
    chunk = pa.chunk_cols(pa.kernel_width(d), pool_k.element_size())
    out = torch.empty_like(q)
    lse = torch.empty((n, h, w))
    view_k = gather_pages(pool_k, bt).float()          # [N, H, L, D]
    view_v = gather_pages(pool_v, bt).float()
    for r in range(n):
        step = int(steps[r])
        for w0 in range(0, w, tile):
            wt = min(tile, w - w0)
            lim0 = min(step + w0, pmax * ps - 1)
            uniform = not bool((vc[r, :lim0 + 1] != 0).any())
            lim = step + w0 + wt - 1
            qs = q[r, :, w0:w0 + wt].float()               # [H, wt, D]
            cur = step + w0 + torch.arange(wt)
            parts = []
            for s in range(splits):
                p0, p1 = s * pps, min(pmax, (s + 1) * pps)
                p_end = p1 if uniform else min(p1, lim // ps + 1)
                warps = []
                for wp in range(WARPS):
                    m = torch.full((h, wt), MASKED)
                    l = torch.zeros((h, wt))
                    o = torch.zeros((h, wt, d))
                    for p in range(p0 + wp, p_end, WARPS):
                        c0, c1 = p * ps, min(p * ps + ps, lim + 1)
                        if not uniform and not (vc[r, c0:c1] != 0).any():
                            continue                      # a dead page
                        for c in range(p * ps, p * ps + ps, chunk):
                            # a page's last chunk may be partial
                            ce = min(c + chunk, p * ps + ps)
                            cols = torch.arange(c, ce)
                            sc = torch.einsum(
                                "hwd,hcd->hwc", qs, view_k[r, :, c:ce]
                            ) / math.sqrt(d)
                            ok = ((vc[r, c:ce] != 0)[None, :]
                                  & (cols[None, :] <= cur[:, None]))
                            sc = sc.masked_fill(~ok[None], MASKED)
                            m_new = torch.maximum(m, sc.amax(-1))
                            alpha = torch.exp(m - m_new)
                            pr = torch.exp(sc - m_new[..., None])
                            l = l * alpha + pr.sum(-1)
                            o = o * alpha[..., None] + torch.einsum(
                                "hwc,hcd->hwd", pr, view_v[r, :, c:ce])
                            m = m_new
                    warps.append((m, l, o))
                parts.append(_merge(*zip(*warps)))
            mx, ls, os_ = _merge(*zip(*parts))
            out[r, :, w0:w0 + wt] = (os_ / ls[..., None]).to(q.dtype)
            lse[r, :, w0:w0 + wt] = mx + torch.log(ls)
    return out, lse


def _case(seed, w, ps=16, n=5, h=2, d=64, pmax=12):
    """Shuffled table, ragged steps and left pads; row 1 fully masked
    with its cursor on the last column; row 2 parked on the sentinel
    page; row 3 at cursor 0; row 4 readable only in its first pages."""
    rng = np.random.default_rng(seed)
    pages = n * pmax
    pool_k = rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32)
    pool_v = rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32)
    bt = rng.permutation(pages).reshape(n, pmax).astype(np.int32)
    lp = pmax * ps
    steps = rng.integers(ps, lp - w + 1, (n,)).astype(np.int32)
    vc = np.ones((n, lp), np.int32)
    vc[0, :rng.integers(1, steps[0])] = 0
    steps[1], vc[1] = lp - w, 0
    bt[2], steps[2], vc[2] = pages, 0, 0
    steps[3] = 0
    steps[4] = lp - w
    vc[4, 2 * ps:] = 0
    q = rng.standard_normal((n, h, w, d)).astype(np.float32)
    return q, pool_k, pool_v, bt, steps, vc


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("w,ps", [(1, 16), (5, 16), (3, 8), (1, 32)])
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_split_and_combine_matches_reference_and_pallas(interpret_kernel, w,
                                                        ps, sms):
    args = _case(w * 31 + ps, w, ps=ps)
    got, got_lse = split_and_combine(*_t(*args), sms=sms)
    ref, ref_lse = pa.paged_attention_reference(*_t(*args))
    j_out, j_lse = jpa.fused_paged_attention(*args, 64)
    for want, want_lse in ((ref.numpy(), ref_lse.numpy()),
                           (np.asarray(j_out), np.asarray(j_lse))):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=ATOL,
                                   rtol=1e-6)
    assert np.isfinite(got.numpy()).all()


def test_w3_tile_with_one_readable_query(interpret_kernel):
    """A W=3 tile whose first two queries have no readable column and
    whose last has one (its own cursor column): the first two get the
    uniform average of the whole table, the last its masked softmax."""
    q, pk, pv, bt, st, vc = _case(77, 3, ps=8)
    st[1], vc[1] = 20, 0
    vc[1, 22] = 1
    args = (q, pk, pv, bt, st, vc)
    got, got_lse = split_and_combine(*_t(*args))
    ref, ref_lse = pa.paged_attention_reference(*_t(*args))
    j_out, _ = jpa.fused_paged_attention(*args, 64)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), ref_lse.numpy(), atol=ATOL,
                               rtol=1e-6)
    mean = gather_pages(*_t(pv, bt))[1].mean(dim=1)      # [H, D]
    for j in (0, 1):
        np.testing.assert_allclose(got[1, :, j].numpy(), mean.numpy(),
                                   atol=ATOL, rtol=0)
    # the last query reads column 22 alone: exactly that column's V
    np.testing.assert_allclose(
        got[1, :, 2].numpy(), gather_pages(*_t(pv, bt))[1, :, 22].numpy(),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("d,ps,w", [(80, 3, 1), (80, 4, 5), (16, 5, 3),
                                    (200, 16, 5), (16, 1, 1)])
def test_split_and_combine_at_any_head_dim_and_page_size(d, ps, w):
    """The walk at head dims that are not 64 or 128 and page sizes whose
    last ring chunk is partial (its columns past the page weigh nothing,
    even in a row with no readable column), against the plain version,
    on the same special rows as above."""
    args = _case(d + ps + w, w, ps=ps, d=d, pmax=7)
    got, got_lse = split_and_combine(*_t(*args))
    ref, ref_lse = pa.paged_attention_reference(*_t(*args))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), ref_lse.numpy(), atol=ATOL,
                               rtol=1e-6)
