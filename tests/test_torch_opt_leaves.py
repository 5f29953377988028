"""The fused AdamW kernel's leaves entry (``fused_adamw_leaves``) on the CPU:
its segment table, a plain model of how the CUDA kernel walks that table,
its plain version against the bucket path, and ``adamw_update``'s fused
path through it against the JAX package's fused kernel in interpret mode.

Tolerances: the leaves path against the bucket path (the leaves
concatenated and zero-padded to the JAX reference's tile of 256 rows, as
the optimizer did before it read the leaves where they lie) bit for bit in
params, payloads, scales and zero points -- both run the same plain
arithmetic on the same rows; the update-norm sums within 1e-6 relative
(the padded bucket adds zero rows, which the CPU's reduction may group
otherwise).  Against JAX the limits of tests/test_torch_train.py, for the
reasons given there: params within 1e-6 of each leaf's largest magnitude,
payloads and zero points at most one codec step apart, scales within 1e-6
relative, the stats within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qconfig import parse_recipe as jparse_recipe
from repro.optim import OptConfig as JOpt
from repro.optim import adamw_update as j_adamw
from repro.optim import init_adam_state as j_init_adam

from repro_torch.core import qadam
from repro_torch.core.qconfig import parse_recipe
from repro_torch.core.quantizer import quantize_int
from repro_torch.kernels import opt_update as ok
from repro_torch.models import opt_state_from_jax
from repro_torch.optim import OptConfig, adamw_update

CODECS = ["m1:8c-b128,m2:8c-asym-b128-sqrt", "m1:8c-b128,m2:8c-b128",
          "m1:8c-b32,m2:8c-asym-b32", "m1:8c-b256,m2:8c-asym-b256-sqrt"]
#: a leaf whose last row is ragged (9100 % 128 != 0), an aligned one and
#: a 3-D one
SHAPES = [(130, 70), (64, 128), (3, 40, 50)]
SC = np.array([0.7, 1e-3, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3,
               1 - 0.95 ** 3], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ptrs(base, step=16):
    return [base + step * i for i in range(8)]


# ---------------------------------------------------------------------------
# the segment table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [32, 64, 128, 256])
def test_segment_table_rows_tails_and_counts(bs):
    """Rows, output offsets, bulk rows (full rows down to a multiple of
    ROW_ALIGN, none where a pointer is unaligned), tiles and direct rows,
    each a running sum over the segments."""
    tile_rows = ok.TILE_ELEMS // bs
    segs = [(_ptrs(4096), 130 * 70),          # ragged last row
            (_ptrs(8192), 64 * 128),           # whole rows
            (_ptrs(4096, 4) , 5000),           # unaligned: all direct
            (_ptrs(1 << 20), 7 * bs),          # 7 full rows: 4 bulk
            (_ptrs(1 << 21), bs - 1)]          # one ragged row
    table, rows, tiles, direct = ok.segment_table(segs, bs)
    assert all(len(r) == len(ok.SEGMENT_FIELDS) for r in table)
    f = {k: [r[i] for r in table] for i, k in enumerate(ok.SEGMENT_FIELDS)}
    want_rows = [-(-n // bs) for _, n in segs]
    assert f["n"] == [n for _, n in segs]
    assert f["rows"] == want_rows
    assert f["dst_row"] == list(np.cumsum([0] + want_rows[:-1]))
    full = [n // bs for _, n in segs]
    want_bulk = [fr // ok.ROW_ALIGN * ok.ROW_ALIGN for fr in full]
    want_bulk[2] = 0
    assert f["bulk_rows"] == want_bulk
    assert all(b % ok.ROW_ALIGN == 0 and b * bs <= n
               for b, (_, n) in zip(f["bulk_rows"], segs))
    ntile = [-(-b // tile_rows) for b in want_bulk]
    ndirect = [r - b for r, b in zip(want_rows, want_bulk)]
    assert f["tile_begin"] == list(np.cumsum([0] + ntile[:-1]))
    assert f["direct_begin"] == list(np.cumsum([0] + ndirect[:-1]))
    assert (rows, tiles, direct) == (sum(want_rows), sum(ntile),
                                     sum(ndirect))
    assert f["g"][2] == 4096 and f["z2"][2] == 4096 + 28
    assert ok.launch_grid(tiles, direct, bs, 132) >= 1


def _kernel_walk(table, tiles, direct, bs, grid):
    """A plain model of the CUDA kernel's walk: for each block, its tiles
    (round robin, the segment found by walking forward) and then each
    consumer warp's direct rows (the segment found by the last
    direct_begin <= d); returns the output rows each (block) wrote."""
    fields = {k: i for i, k in enumerate(ok.SEGMENT_FIELDS)}
    tile_rows = ok.TILE_ELEMS // bs
    rows_a_warp = ok.warp_rows(bs)
    written = []
    for b in range(grid):
        s = 0
        for t in range(b, tiles, grid):
            while (s + 1 < len(table)
                   and table[s + 1][fields["tile_begin"]] <= t):
                s += 1
            seg = table[s]
            row0 = (t - seg[fields["tile_begin"]]) * tile_rows
            nr = min(tile_rows, seg[fields["bulk_rows"]] - row0)
            assert nr > 0 and nr % ok.ROW_ALIGN == 0
            written += [(b, seg[fields["dst_row"]] + row0 + r)
                        for r in range(nr)]
        units = -(-direct // rows_a_warp)
        for w in range(ok.CONSUMER_WARPS):
            for u in range(b * ok.CONSUMER_WARPS + w, units,
                           grid * ok.CONSUMER_WARPS):
                for d in range(u * rows_a_warp, (u + 1) * rows_a_warp):
                    if d >= direct:
                        continue
                    s = max(i for i, r in enumerate(table)
                            if r[fields["direct_begin"]] <= d)
                    seg = table[s]
                    r = seg[fields["bulk_rows"]] + d - seg[
                        fields["direct_begin"]]
                    assert r < seg[fields["rows"]]
                    written.append((b, seg[fields["dst_row"]] + r))
    return written


@pytest.mark.parametrize("bs", [32, 64, 128, 256])
@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("max_segments", [2, ok.MAX_SEGMENTS])
def test_kernel_walk_writes_every_row_once(bs, sms, max_segments,
                                           monkeypatch):
    """Under the kernel's assignment every output row is written by
    exactly one block, for any grid the wrapper may choose, and with the
    segments split over several launches (at most ``MAX_SEGMENTS`` a
    launch; 2 here stands for a model with more than 256 leaves)."""
    monkeypatch.setattr(ok, "MAX_SEGMENTS", max_segments)
    segs = [(_ptrs(4096), 130 * 70), (_ptrs(4096, 4), 3 * bs + 5),
            (_ptrs(8192), 40 * ok.TILE_ELEMS + 9 * bs),
            (_ptrs(16384), bs - 3), (_ptrs(32768), 64 * 128)]
    plan = ok.launch_plan(segs, bs, sms)
    assert len(plan) == -(-len(segs) // max_segments)
    written = []
    for table, tiles, direct, grid in plan:
        assert len(table) <= max_segments
        assert 1 <= grid <= ok.BLOCKS_PER_SM * sms
        written += [r for _, r in _kernel_walk(table, tiles, direct, bs,
                                               grid)]
    assert sorted(written) == list(range(sum(-(-n // bs) for _, n in segs)))


# ---------------------------------------------------------------------------
# the plain version against the bucket path
# ---------------------------------------------------------------------------

def _leaves(rng, rec, shapes):
    g, p, m1, m2 = [], [], [], []
    for sh in shapes:
        p.append(torch.from_numpy(rng.randn(*sh).astype(np.float32)))
        g.append(torch.from_numpy((rng.randn(*sh) * 1e-2).astype(np.float32)))
        m1.append(qadam.QState(*quantize_int(torch.from_numpy(
            (rng.randn(*sh) * 1e-3).astype(np.float32)), rec.adam_m1)))
        m2.append(qadam.QState(*quantize_int(torch.from_numpy(
            np.sqrt(rng.rand(*sh) * 1e-5).astype(np.float32)), rec.adam_m2)))
    return g, p, m1, m2


def _bucket_path(g, p, m1, m2, sc, bs, **kw):
    """What the optimizer ran before: the leaves concatenated into one
    bucket padded to 256 rows, ``fused_adamw_blocks`` in place, views."""
    parts = [torch.cat([qadam.flatten_blocks(x.to(torch.float32), bs)
                        for x in g]),
             torch.cat([qadam.flatten_blocks(x, bs) for x in p]),
             *(torch.cat([st[j] for st in states])
               for states in (m1, m2) for j in range(3))]
    pad = (-parts[0].shape[0]) % 256
    parts = [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in parts]
    new_p, nm1, nm2, sumsq = ok.fused_adamw_blocks(*parts, sc, **kw)
    out_p, out_m1, out_m2, off = [], [], [], 0
    for leaf in p:
        nb = -(-leaf.numel() // bs)
        sl = slice(off, off + nb)
        out_p.append(qadam.unflatten_blocks(new_p[sl], leaf.shape))
        out_m1.append(tuple(t[sl] for t in nm1))
        out_m2.append(tuple(t[sl] for t in nm2))
        off += nb
    return out_p, out_m1, out_m2, sumsq


def _flat(out):
    p, m1, m2, _ = out
    return [*p, *(t for m in m1 for t in m), *(t for m in m2 for t in m)]


@pytest.mark.parametrize("codec", CODECS)
def test_leaves_plain_equals_bucket_path(codec):
    """Two steps: the second reads the first's outputs, views into its
    bucket, as the optimizer's steady state does."""
    rec = parse_recipe(codec)
    bs = rec.adam_m1.block_size
    rng = np.random.RandomState(len(codec))
    g, p, m1, m2 = _leaves(rng, rec, SHAPES)
    kw = dict(m1_codec=ok.codec_of(rec.adam_m1),
              m2_codec=ok.codec_of(rec.adam_m2), weight_decay=True)
    sc = torch.from_numpy(SC)
    inputs = (g, p, m1, m2)
    for step in range(2):
        before = [t.clone() for t in _flat((*inputs[1:], None))]
        got = ok.fused_adamw_leaves(*inputs, sc, **kw)
        want = _bucket_path(*inputs, sc, bs, **kw)
        assert ok.fused_adamw_leaves.launches == 0      # the CPU: plain
        for a, b in zip(_flat(got), _flat(want)):
            assert a.shape == b.shape and torch.equal(a, b), step
        assert abs(float(got[3]) - float(want[3])) <= \
            1e-6 * float(want[3])
        # the inputs are not modified, and the outputs share one bucket
        for a, b in zip(_flat((*inputs[1:], None)), before):
            assert torch.equal(a, b)
        base = got[0][0].untyped_storage().data_ptr()
        assert all(t.untyped_storage().data_ptr() == base for t in got[0])
        g = [x * 0.5 for x in g]
        inputs = (g, *got[:3])
    assert got[1][0][0].shape == (-(-130 * 70 // bs), bs)


def test_leaves_reject_what_the_kernel_cannot_take():
    rec = parse_recipe(CODECS[0])
    rng = np.random.RandomState(0)
    g, p, m1, m2 = _leaves(rng, rec, SHAPES[:2])
    kw = dict(m1_codec=ok.codec_of(rec.adam_m1),
              m2_codec=ok.codec_of(rec.adam_m2), weight_decay=True)
    sc = torch.from_numpy(SC)
    with pytest.raises(ValueError, match="leaf 1"):
        ok.fused_adamw_leaves(g, [p[0], p[1].t()], m1, m2, sc, **kw)
    with pytest.raises(ValueError, match="leaf 0: moment"):
        ok.fused_adamw_leaves(g, p, [qadam.QState(m1[0].q[:-1], *m1[0][1:]),
                                     m1[1]], m2, sc, **kw)
    with pytest.raises(ValueError):
        ok.fused_adamw_leaves(g[:1], p, m1, m2, sc, **kw)


# ---------------------------------------------------------------------------
# adamw_update's fused path against the JAX package
# ---------------------------------------------------------------------------

def _assert_moments_close(t, j):
    dq = np.abs(t[0].numpy().astype(np.int32) - np.asarray(j[0], np.int32))
    assert dq.max() <= 1
    s_t, s_j = t[1].numpy(), np.asarray(j[1])
    assert (np.abs(s_t - s_j) <= 1e-6 * np.abs(s_j)).all()
    assert np.abs(t[2].numpy() - np.asarray(j[2])).max() <= 1


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("codec", CODECS[:2])
def test_adamw_update_fused_matches_jax_kernel(codec, monkeypatch):
    """One ``adamw_update(fused=True)`` step -- the leaves entry's plain
    version, its moments views into one earlier bucket -- against JAX's
    fused path (its Pallas kernel in interpret mode) from the same state."""
    monkeypatch.setenv("REPRO_FUSED_ADAM", "0")
    jr, tr = jparse_recipe(codec), parse_recipe(codec)
    rng = np.random.RandomState(11)
    params = {f"w{i}": rng.randn(*sh).astype(np.float32)
              for i, sh in enumerate(SHAPES)}
    params["bias"] = rng.randn(128).astype(np.float32)
    grads = [{k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10 ** 6,
              weight_decay=0.1, grad_clip=1.0, state_storage="int")
    jcfg, tcfg = JOpt(**kw), OptConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = j_init_adam(jp, jr, jcfg)
    jp, jst, _ = j_adamw(jp, {k: jnp.asarray(v) for k, v in grads[0].items()},
                         jst, jcfg, jr)
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    tst = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                             device="cpu")
    # the optimizer's steady state: each moment a view into one bucket
    names = [k for k in params if k != "bias"]
    for key in ("m1", "m2"):
        states = getattr(tst, key)
        cat = [torch.cat([states[k][j] for k in names]) for j in range(3)]
        off = 0
        for k in names:
            nb = states[k].q.shape[0]
            states[k] = qadam.QState(*(t[off:off + nb] for t in cat))
            off += nb
    monkeypatch.setenv("REPRO_FUSED_ADAM", "1")
    jp2, jst2, jstats = j_adamw(
        jp, {k: jnp.asarray(v) for k, v in grads[1].items()}, jst, jcfg, jr)
    tp2, tst2, tstats = adamw_update(
        tp, {k: torch.from_numpy(v) for k, v in grads[1].items()}, tst, tcfg,
        tr, fused=True)
    for k in names:
        assert _rel_max(tp2[k].numpy(), np.asarray(jp2[k])) <= 1e-6, k
        _assert_moments_close(tst2.m1[k], jst2.m1[k])
        _assert_moments_close(tst2.m2[k], jst2.m2[k])
    assert _rel_max(tp2["bias"].numpy(), np.asarray(jp2["bias"])) <= 1e-6
    for name in ("lr", "grad_norm", "update_norm"):
        assert abs(float(tstats[name]) - float(jstats[name])) <= \
            1e-5 * abs(float(jstats[name])), name
