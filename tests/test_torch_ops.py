"""The port's ops (dynamo_tpu_torch.ops) against the JAX package's.

Inputs are made with numpy from a seed and fed to both.  Paged attention's
plain PyTorch versions are held against the JAX einsum path AND against
the Pallas kernels run in interpret mode (as tests/test_pallas_attention.py
runs them).  Tolerances: 1e-6 for norm/rope in f32; 2e-5 (f32) and 5e-2
(bf16) for attention, whose sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import norm as jnorm
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu.ops import rotary as jrot
from dynamo_tpu.ops.pallas_attention import (
    decode_attention_pallas,
    prefill_attention_pallas,
)
from dynamo_tpu_torch.ops import cuda_attention, norm, paged_attention, rotary

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"f32": 2e-5, "bf16": 5e-2}


def _both(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of dtype `dt`."""
    jd, td = _DT[dt]
    return jnp.asarray(a, jnp.float32).astype(jd), torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = norm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


_SCALINGS = {
    "plain": None,
    "llama3": {"factor": 8.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
               "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "yarn": {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
             "beta_slow": 1.0, "original_max_position_embeddings": 4096,
             "truncate": False},
    "yarn-truncated": {"rope_type": "yarn", "factor": 4.0,
                       "original_max_position_embeddings": 2048},
}


@pytest.mark.parametrize("kind", list(_SCALINGS))
def test_rope_frequencies_and_scale(kind):
    sc = _SCALINGS[kind]
    for hd, theta in ((64, 150000.0), (128, 500000.0)):
        want = jrot.rope_frequencies(hd, theta, sc)
        got = rotary.rope_frequencies(hd, theta, sc)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)
    assert rotary.rope_attention_scale(sc) == pytest.approx(
        jrot.rope_attention_scale(sc), rel=1e-12)


@pytest.mark.parametrize("kind", ["llama3", "yarn"])
def test_apply_rope(kind):
    sc = _SCALINGS[kind]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 7)).astype(np.int32)
    scale = jrot.rope_attention_scale(sc)
    want = jrot.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                           jrot.rope_frequencies(64, 10000.0, sc), scale)
    got = rotary.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            rotary.rope_frequencies(64, 10000.0, sc), scale)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


def _table(seq_lens, maxp, page):
    """Distinct live pages per row; unused entries point at trash page 0."""
    table = np.zeros((len(seq_lens), maxp), np.int32)
    nxt = 1
    for b, s in enumerate(seq_lens):
        n = -(-int(s) // page)
        table[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return table, nxt


def test_write_kv_pages_byte_equal():
    rng = np.random.default_rng(2)
    P, page, n_kv, hd, B, S = 12, 4, 2, 8, 3, 6
    table, _ = _table([16, 16, 12], 4, page)
    pool_k = rng.standard_normal((P, page, n_kv, hd)).astype(np.float32)
    pool_v = rng.standard_normal((P, page, n_kv, hd)).astype(np.float32)
    k_new = rng.standard_normal((B, S, n_kv, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, S, n_kv, hd)).astype(np.float32)
    pos = np.array([0, 5, 9], np.int32)
    lens = np.array([6, 3, 0], np.int32)
    jk, jv = jpa.write_kv_pages(*map(jnp.asarray, (pool_k, pool_v, k_new, v_new,
                                                   table, pos, lens)))
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    paged_attention.write_kv_pages(
        tk, tv, *map(torch.from_numpy, (k_new, v_new, table, pos, lens)))
    # page 0 is the trash page: padding writes land there in any order
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])


_DECODE = [  # (dtype, window, sink)
    ("f32", None, False),
    ("bf16", None, False),
    ("f32", 8, False),
    ("f32", 64, True),
    ("f32", 1000, False),
    ("bf16", 64, True),
]


@pytest.mark.parametrize("dt,window,sink", _DECODE)
def test_decode_attention_plain_matches_jax(dt, window, sink):
    rng = np.random.default_rng(3)
    B, H, n_kv, hd, page, maxp = 3, 4, 2, 64, 16, 14
    seq_lens = np.array([1, 17, 209], np.int32)
    table, P = _table(seq_lens, maxp, page)
    kp = rng.standard_normal((P, page, n_kv, hd)) * 0.3
    vp = rng.standard_normal((P, page, n_kv, hd)) * 0.3
    q = rng.standard_normal((B, H, hd)) * 0.5
    s = rng.standard_normal(H).astype(np.float32) if sink else None
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dt), _both(kp, dt), _both(vp, dt)
    jsink = None if s is None else jnp.asarray(s)
    tsink = None if s is None else torch.from_numpy(s)
    got = _np(paged_attention.decode_attention(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(seq_lens),
        window=window, sink=tsink))
    jt, jl = jnp.asarray(table), jnp.asarray(seq_lens)
    ein = jpa.decode_attention(jq, jk, jv, jt, jl, window=window, sink=jsink)
    pal = decode_attention_pallas(jq, jk, jv, jt, jl, window=window,
                                  sink=jsink, interpret=True)
    tol = _TOL[dt]
    np.testing.assert_allclose(got, _np(ein), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, _np(pal), atol=tol, rtol=tol)


_PREFILL = [  # (dtype, prefix, window, sink)
    ("f32", 0, None, False),
    ("f32", 48, None, False),
    ("f32", 48, 8, False),
    ("f32", 0, 64, True),
    ("f32", 48, 1000, True),
    ("bf16", 48, None, False),
]


@pytest.mark.parametrize("dt,prefix,window,sink", _PREFILL)
def test_prefill_attention_plain_matches_jax(dt, prefix, window, sink):
    rng = np.random.default_rng(4)
    B, H, n_kv, hd, page, maxp, S = 3, 4, 2, 64, 16, 6, 32
    prefix_lens = np.array([prefix, 0, max(prefix - 16, 0)], np.int32)
    chunk_lens = np.array([S, S - 13, 1], np.int32)
    table, P = _table([maxp * page] * B, maxp, page)
    kp = rng.standard_normal((P, page, n_kv, hd)) * 0.3
    vp = rng.standard_normal((P, page, n_kv, hd)) * 0.3
    q = rng.standard_normal((B, S, H, hd)) * 0.5
    kn = rng.standard_normal((B, S, n_kv, hd)) * 0.3
    vn = rng.standard_normal((B, S, n_kv, hd)) * 0.3
    s = rng.standard_normal(H).astype(np.float32) if sink else None
    pairs = [_both(a, dt) for a in (q, kn, vn, kp, vp)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    jsink = None if s is None else jnp.asarray(s)
    tsink = None if s is None else torch.from_numpy(s)
    got = _np(paged_attention.prefill_attention(
        *ts, torch.from_numpy(table), torch.from_numpy(prefix_lens),
        torch.from_numpy(chunk_lens), window=window, sink=tsink))
    jargs = (*js, jnp.asarray(table), jnp.asarray(prefix_lens),
             jnp.asarray(chunk_lens))
    ein = _np(jpa.prefill_attention(*jargs, window=window, sink=jsink))
    pal = _np(prefill_attention_pallas(*jargs, window=window, sink=jsink,
                                       interpret=True))
    tol = _TOL[dt]
    for b in range(B):  # rows at or past chunk_len are unspecified
        n = int(chunk_lens[b])
        np.testing.assert_allclose(got[b, :n], ein[b, :n], atol=tol, rtol=tol)
        np.testing.assert_allclose(got[b, :n], pal[b, :n], atol=tol, rtol=tol)


def test_empty_rows_give_zeros():
    """A decode row with seq_len 0 and a prefill row with chunk_len 0
    attend to nothing: zeros, as the CUDA kernels give (never NaN)."""
    rng = np.random.default_rng(5)
    kp = torch.from_numpy(rng.standard_normal((3, 4, 1, 8)).astype(np.float32))
    vp = kp.clone()
    table = torch.tensor([[1], [2]], dtype=torch.int32)
    out = paged_attention.decode_attention(
        torch.ones(2, 2, 8), kp, vp, table, torch.tensor([0, 3], dtype=torch.int32),
        sink=torch.zeros(2))
    assert torch.equal(out[0], torch.zeros(2, 8)) and torch.isfinite(out).all()
    q = torch.ones(1, 2, 2, 8)
    out = paged_attention.prefill_attention(
        q, torch.ones(1, 2, 1, 8), torch.ones(1, 2, 1, 8), kp, vp, table[:1],
        torch.tensor([0], dtype=torch.int32), torch.tensor([0], dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("fn", ["decode", "prefill"])
def test_cuda_wrappers_refuse_cpu_tensors(fn):
    """The kernel wrappers launch or raise; they never compute on the CPU."""
    q = torch.zeros(1, 1, 2, 64) if fn == "prefill" else torch.zeros(1, 2, 64)
    pool = torch.zeros(2, 16, 1, 64)
    table = torch.ones(1, 1, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        if fn == "decode":
            cuda_attention.decode_attention_cuda(q, pool, pool, table, lens)
        else:
            kn = torch.zeros(1, 1, 1, 64)
            cuda_attention.prefill_attention_cuda(q, kn, kn, pool, pool, table,
                                                  lens, lens)


_SPLIT = [  # (n_split, window, sink)
    (1, None, False),
    (3, None, True),
    (8, None, False),
    (3, 40, True),
    (8, 100, True),
    (8, 8, False),
]


@pytest.mark.parametrize("n_split,window,sink", _SPLIT)
def test_decode_split_plain_matches_jax(n_split, window, sink):
    """The split-KV twin (per-split partials merged as the CUDA kernel pair
    merges them) against the JAX einsum path: ragged rows, a row with
    seq_len 0, and splits that lie wholly past a row's end or before its
    window."""
    rng = np.random.default_rng(7)
    B, H, n_kv, hd, page, maxp = 4, 8, 2, 64, 16, 14
    seq_lens = np.array([1, 0, 209, 37], np.int32)
    table, P = _table(seq_lens, maxp, page)
    kp = rng.standard_normal((P, page, n_kv, hd)) * 0.3
    vp = rng.standard_normal((P, page, n_kv, hd)) * 0.3
    q = rng.standard_normal((B, H, hd)) * 4.0  # peaked: the merge's rescale matters
    s = rng.standard_normal(H).astype(np.float32) if sink else None
    (jq, tq), (jk, tk), (jv, tv) = _both(q, "f32"), _both(kp, "f32"), _both(vp, "f32")
    got = _np(paged_attention.decode_attention_split_plain(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(seq_lens),
        window=window, sink=None if s is None else torch.from_numpy(s),
        n_split=n_split))
    want = _np(jpa.decode_attention(jq, jk, jv, jnp.asarray(table),
                                    jnp.asarray(seq_lens), window=window,
                                    sink=None if s is None else jnp.asarray(s)))
    live = seq_lens > 0  # the JAX path leaves a seq_len-0 row unspecified
    np.testing.assert_allclose(got[live], want[live], atol=2e-5, rtol=2e-5)
    assert np.all(got[1] == 0)  # the kernels' zeros, sink or not


def test_decode_split_count_is_a_function_of_shapes():
    """The wrapper's splits read only shapes (never seq_lens, which would
    be a host sync); a split is a constant run of whole pages, so a row's
    splits do not change with the table width its batch-mates set; the
    splits cover the table and fill the card at least twice over at the
    phase-3 ragged shape and the serving shape."""
    import inspect

    f, sp = cuda_attention.decode_num_splits, cuda_attention.decode_split_pages
    assert list(inspect.signature(f).parameters) == ["max_pages", "page"]
    assert sp(16) * 16 == cuda_attention.DECODE_SPLIT_KEYS
    assert sp(8) == 2 * sp(16) and sp(512) == 1
    for B, n_kv, maxp, page in ((4, 8, 256, 16), (8, 8, 130, 16)):
        n = f(maxp, page)
        assert (n - 1) * sp(page) < maxp <= n * sp(page)
        assert B * n_kv * n >= 2 * 132
    assert f(1, 16) == 1


def test_decode_split_plain_is_batch_invariant():
    """A row's output under the wrapper's splits is bit for bit the same
    whether its table is its own width or widened (as a longer batch-mate
    widens it), while another split of the same row moves its bits: the
    split boundaries, not the table width, fix the f32 sums."""
    rng = np.random.default_rng(8)
    H, n_kv, hd, page = 4, 2, 64, 16
    lens = np.array([300, 1000], np.int32)
    table, P = _table(lens, 63, page)
    kp = torch.from_numpy((rng.standard_normal((P, page, n_kv, hd)) * 0.3).astype(np.float32))
    vp = torch.from_numpy((rng.standard_normal((P, page, n_kv, hd)) * 0.3).astype(np.float32))
    q = torch.from_numpy((rng.standard_normal((2, H, hd)) * 4).astype(np.float32))
    sp = cuda_attention.decode_split_pages(page)

    def run(width):  # row 0 with its table cut to `width` pages
        t = torch.from_numpy(np.ascontiguousarray(table[[0], :width]))
        return paged_attention.decode_attention_split_plain(
            q[[0]], kp, vp, t, torch.from_numpy(lens[[0]]),
            n_split=cuda_attention.decode_num_splits(width, page), split_pages=sp)

    alone = run(19)  # 300 tokens: 19 pages, 2 splits
    widened = run(63)  # the width of the 1000-token row: 4 splits
    assert torch.equal(alone, widened)
    other = paged_attention.decode_attention_split_plain(
        q[[0]], kp, vp, torch.from_numpy(np.ascontiguousarray(table[[0], :19])),
        torch.from_numpy(lens[[0]]), n_split=19)  # one page a split
    assert not torch.equal(alone, other)
    torch.testing.assert_close(alone, other, rtol=1e-5, atol=1e-6)
