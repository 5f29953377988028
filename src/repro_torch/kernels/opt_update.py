"""Fused 8-bit AdamW update: one pass over rows of block-quantized
moments (port of ``repro/kernels/opt_update.py:fused_adamw_blocks``).

The reference loop (``optim/adamw.py``) decodes each int8 moment to fp32,
runs the update as separate elementwise ops and re-encodes: about six
passes over moment-sized buffers.  One kernel body (``csrc/opt_update.cu``)
does the whole step per row in one pass, with two entries:

* :func:`fused_adamw_blocks` -- a (rows, block_size) bucket, in place (the
  counterpart of the JAX kernel's contract);
* :func:`fused_adamw_leaves` -- the leaves where they lie, one segment of
  the kernel's table a leaf (:func:`segment_table`), written into one
  fresh bucket; it returns views into that bucket shaped as the leaves.
  This is what ``optim/adamw.py`` calls: no concatenated copy of the
  gradients, params and moments is made.

Each launches the kernel on CUDA tensors and runs its plain version
(:func:`fused_adamw_blocks_plain`, :func:`fused_adamw_leaves_plain`) on
CPU tensors.  The row layout is ``core.qadam``'s blockwise codec: each row
is one quantization block of both moments with its own (scale, zero) pair;
a leaf's last row is zero-padded past its end (``flatten_blocks``).

Both versions follow the reference kernel op for op: the eight scalars are
float32 values (so ``1 - b1`` is a float32 subtraction, as in the JAX
kernel, and not the Python-float constant of the loop), divisions are IEEE
and nothing is fused into an FMA, so kernel and plain version agree bit
for bit except for the update-norm partial sums, which add in another
order.  Zero-padded rows (0 payloads, 0 scales) decode to 0, update to 0
and keep finite fresh scales through the 1e-12 guards.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.qadam import flatten_blocks, unflatten_blocks
from repro_torch.core.quantizer import _EPS, _div
from repro_torch.kernels import _build

#: scalar vector layout, one fp32 slot each (SMEM on the TPU; a device
#: array here, so the step never syncs to the host for clip or lr)
SCALARS = ("clip", "lr", "b1", "b2", "eps", "wd", "c1", "c2")
#: values a tile of the CUDA kernel (``csrc/opt_update.cu:kTileElems``):
#: a tile is ``TILE_ELEMS // block_size`` rows, staged by bulk copies
TILE_ELEMS = 2048
#: bulk rows start at multiples of this, so the 4-byte scale runs of a
#: tile are whole 16-byte copies
ROW_ALIGN = 4
#: resident blocks an SM (the kernel's launch bounds) and consumer warps
#: a block
BLOCKS_PER_SM, CONSUMER_WARPS = 3, 8
#: segments a launch takes (``csrc/opt_update.cu:kMaxSegments``: the
#: table is a kernel parameter, at most 32 KB)
MAX_SEGMENTS = 256
#: int64 fields of one segment (``csrc/opt_update.cu:Segment``)
SEGMENT_FIELDS = ("g", "p", "q1", "s1", "z1", "q2", "s2", "z2", "n", "rows",
                  "dst_row", "bulk_rows", "tile_begin", "direct_begin")


class MomentCodec(NamedTuple):
    """Per-moment codec parameters the kernel bakes in (the QuantSpec
    fields of the blockwise int path)."""
    qmin: int
    qmax: int
    symmetric: bool
    sqrt_domain: bool


def codec_of(spec) -> MomentCodec:
    return MomentCodec(qmin=spec.qmin, qmax=spec.qmax,
                       symmetric=spec.symmetric,
                       sqrt_domain=spec.sqrt_domain)


def _dequant(q, s, z, codec: MomentCodec) -> torch.Tensor:
    deq = s * (q.to(torch.float32) + z)
    return torch.square(deq) if codec.sqrt_domain else deq


def _requant(x: torch.Tensor, codec: MomentCodec
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """quantize_int's blockwise row codec: one (scale, zero) per row."""
    if codec.sqrt_domain:
        x = torch.sqrt(torch.clamp_min(x, 0.0))
    if codec.symmetric:
        absmax = torch.amax(x.abs(), dim=-1, keepdim=True)
        scale = _div(absmax.clamp_min(_EPS), codec.qmax)
        zero = torch.zeros_like(scale)
    else:
        xmin = torch.amin(x, dim=-1, keepdim=True)
        xmax = torch.amax(x, dim=-1, keepdim=True)
        scale = _div((xmax - xmin).clamp_min(_EPS), codec.qmax - codec.qmin)
        zero = torch.round(xmin / scale) - codec.qmin
    q = torch.clamp(torch.round(x / scale) - zero, codec.qmin, codec.qmax)
    return q.to(torch.int8), scale, zero


def fused_adamw_blocks_plain(g, p, m1_q, m1_scale, m1_zero, m2_q, m2_scale,
                             m2_zero, scalars, *, m1_codec: MomentCodec,
                             m2_codec: MomentCodec, weight_decay: bool):
    """Plain PyTorch version of :func:`fused_adamw_blocks` (same contract,
    same in-place updates)."""
    clip, lr, b1, b2, eps, wd, c1, c2 = scalars.unbind(0)
    gf = g.to(torch.float32) * clip
    pf = p.to(torch.float32)
    mom1 = b1 * _dequant(m1_q, m1_scale, m1_zero, m1_codec) + (1 - b1) * gf
    mom2 = (b2 * _dequant(m2_q, m2_scale, m2_zero, m2_codec)
            + (1 - b2) * torch.square(gf))
    upd = (mom1 / c1) / (torch.sqrt(mom2 / c2) + eps)
    if weight_decay:
        upd = upd + wd * pf
    delta = lr * upd
    p.copy_(pf - delta)
    for (q, s, z), mom, codec in (((m1_q, m1_scale, m1_zero), mom1, m1_codec),
                                  ((m2_q, m2_scale, m2_zero), mom2, m2_codec)):
        nq, ns, nz = _requant(mom, codec)
        q.copy_(nq)
        s.copy_(ns)
        z.copy_(nz)
    return (p, (m1_q, m1_scale, m1_zero), (m2_q, m2_scale, m2_zero),
            torch.sum(torch.square(delta)))


def segment_table(segments: Sequence[Tuple[Sequence[int], int]],
                  block_size: int, first_row: int = 0
                  ) -> Tuple[List[List[int]], int, int, int]:
    """The CUDA kernel's table: one row of :data:`SEGMENT_FIELDS` a
    segment, from ``(pointers, n)`` pairs -- the eight source addresses (g,
    p, q1, s1, z1, q2, s2, z2) and the segment's element count.  Its rows
    ``ceil(n / block_size)`` follow the previous segment's in the output
    bucket, the first at ``first_row``.  Rows ``[0, bulk_rows)`` stream
    through the kernel's ring in
    tiles of ``TILE_ELEMS // block_size`` rows: the full rows, down to a
    multiple of :data:`ROW_ALIGN`, where every pointer is 16-byte aligned,
    else none.  The rest (the ragged last row, and every row of an
    unaligned segment) take the kernel's direct path.  Returns (table,
    its rows, tiles, direct rows)."""
    tile_rows = TILE_ELEMS // block_size
    table, rows_total, tiles, direct = [], 0, 0, 0
    for ptrs, n in segments:
        rows = -(-n // block_size)
        aligned = all(int(a) % 16 == 0 for a in ptrs)
        bulk = (n // block_size) // ROW_ALIGN * ROW_ALIGN if aligned else 0
        table.append([*map(int, ptrs), n, rows, first_row + rows_total, bulk,
                      tiles, direct])
        rows_total += rows
        tiles += -(-bulk // tile_rows)
        direct += rows - bulk
    return table, rows_total, tiles, direct


def warp_rows(block_size: int) -> int:
    """Rows a consumer warp of the CUDA kernel updates at once: a row is
    ``block_size / 8`` lanes, at most 32."""
    return max(1, 256 // block_size)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_grid(tiles: int, direct: int, block_size: int, sm_count: int
                ) -> int:
    """Blocks of one launch: enough for every tile and every warp's share
    of the direct rows, at most :data:`BLOCKS_PER_SM` an SM.  The tiles'
    order over blocks, and so the update-norm partials, depend only on
    this and the table."""
    warps = -(-direct // warp_rows(block_size))
    return max(1, min(BLOCKS_PER_SM * sm_count,
                      max(tiles, -(-warps // CONSUMER_WARPS))))


def _check_codecs(what, m1_codec, m2_codec, bs):
    if bs not in (32, 64, 128, 256):
        raise ValueError(f"{what}: block size {bs}; the CUDA kernel takes "
                         "32, 64, 128 or 256")
    for c in (m1_codec, m2_codec):
        if c.qmin < -128 or c.qmax > 127:
            raise ValueError(f"{what}: codec {c} exceeds int8")


def launch_plan(segments, block_size: int, sm_count: int):
    """The launches for ``segments``: groups of at most
    :data:`MAX_SEGMENTS`, each (table, tiles, direct rows, grid), their
    rows following each other in the output bucket."""
    plan, row = [], 0
    for i in range(0, len(segments), MAX_SEGMENTS):
        table, rows, tiles, direct = segment_table(
            segments[i:i + MAX_SEGMENTS], block_size, first_row=row)
        plan.append((table, tiles, direct,
                     launch_grid(tiles, direct, block_size, sm_count)))
        row += rows
    return plan


def _launch(what, segments, out, scalars, bs, m1_codec, m2_codec,
            weight_decay):
    """The kernel over ``segments`` into ``out`` (p, q1, s1, z1, q2, s2,
    z2 of the output bucket), one launch a group of segments; returns the
    update-norm sum (the partials of every block, in a fixed order)."""
    dev = out[0].device
    plan = launch_plan(segments, bs, _sm_count(dev.index or 0))
    partial = torch.empty(sum(grid for *_, grid in plan),
                          dtype=torch.float32, device=dev)
    lib = _build.load("opt_update")
    first = 0
    for table, tiles, direct, grid in plan:
        flat = (ctypes.c_longlong * (len(table) * len(SEGMENT_FIELDS)))(
            *itertools.chain.from_iterable(table))
        rc = lib.repro_fused_adamw(
            ctypes.addressof(flat), len(table), tiles, direct,
            TILE_ELEMS // bs, grid, *(t.data_ptr() for t in out),
            scalars.data_ptr(), partial.data_ptr() + 4 * first, bs,
            m1_codec.qmin, m1_codec.qmax, int(m1_codec.symmetric),
            int(m1_codec.sqrt_domain), m2_codec.qmin, m2_codec.qmax,
            int(m2_codec.symmetric), int(m2_codec.sqrt_domain),
            int(bool(weight_decay)), _build.stream_of(out[0]))
        _build.check(lib, rc, what)
        first += grid
    return torch.sum(partial)


def fused_adamw_blocks(g, p, m1_q, m1_scale, m1_zero, m2_q, m2_scale,
                       m2_zero, scalars, *, m1_codec: MomentCodec,
                       m2_codec: MomentCodec, weight_decay: bool):
    """One fused AdamW step over a (rows, block_size) bucket, **in place**:
    ``p`` and the six moment tensors are overwritten with their new values
    (the JAX kernel returns fresh arrays; the caller here owns the bucket).

    ``g``, ``p``: fp32 (rows, bs); ``m?_q``: int8 (rows, bs); ``m?_scale``,
    ``m?_zero``: fp32 (rows, 1); ``scalars``: fp32 (8,) in :data:`SCALARS`
    order, on the tensors' device.  Returns (p, (m1_q, m1_scale, m1_zero),
    (m2_q, m2_scale, m2_zero), update_sumsq) with ``update_sumsq`` the sum
    of (lr * update)^2 over the bucket, a 0-d tensor.

    CPU tensors take :func:`fused_adamw_blocks_plain`; CUDA tensors launch
    the kernel (one segment whose source is its destination; bs 32, 64,
    128 or 256, any row count) or raise."""
    rows, bs = g.shape
    args = (g, p, m1_q, m1_scale, m1_zero, m2_q, m2_scale, m2_zero)
    for name, t, dt, shape in (
            ("g", g, torch.float32, (rows, bs)),
            ("p", p, torch.float32, (rows, bs)),
            ("m1_q", m1_q, torch.int8, (rows, bs)),
            ("m1_scale", m1_scale, torch.float32, (rows, 1)),
            ("m1_zero", m1_zero, torch.float32, (rows, 1)),
            ("m2_q", m2_q, torch.int8, (rows, bs)),
            ("m2_scale", m2_scale, torch.float32, (rows, 1)),
            ("m2_zero", m2_zero, torch.float32, (rows, 1)),
            ("scalars", scalars, torch.float32, (len(SCALARS),))):
        if (t.dtype != dt or tuple(t.shape) != shape
                or t.device != g.device or not t.is_contiguous()):
            raise ValueError(f"fused_adamw_blocks: {name} must be a "
                             f"contiguous {dt} {shape} tensor on {g.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if g.device.type == "cpu":
        return fused_adamw_blocks_plain(
            *args, scalars, m1_codec=m1_codec, m2_codec=m2_codec,
            weight_decay=weight_decay)
    if g.device.type != "cuda":
        raise ValueError(f"fused_adamw_blocks: unsupported device {g.device}")
    _check_codecs("fused_adamw_blocks", m1_codec, m2_codec, bs)
    out = (p, m1_q, m1_scale, m1_zero, m2_q, m2_scale, m2_zero)
    # the bucket's direct-path rows store element by element, so an
    # unaligned bucket is taken whole by that path (segment_table)
    sumsq = _launch("fused_adamw_blocks",
                    [([t.data_ptr() for t in args], rows * bs)], out,
                    scalars, bs, m1_codec, m2_codec, weight_decay)
    fused_adamw_blocks.launches += 1
    return (p, (m1_q, m1_scale, m1_zero), (m2_q, m2_scale, m2_zero), sumsq)


def _leaf_views(p_leaves, bucket, bs):
    """Per-leaf views into a (p, q1, s1, z1, q2, s2, z2) bucket, in order:
    (new params shaped as ``p_leaves``, m1 triples, m2 triples)."""
    p_out, m1, m2, off = [], [], [], 0
    for leaf in p_leaves:
        nb = -(-leaf.numel() // bs)
        sl = slice(off, off + nb)
        p_out.append(unflatten_blocks(bucket[0][sl], leaf.shape))
        m1.append(tuple(t[sl] for t in bucket[1:4]))
        m2.append(tuple(t[sl] for t in bucket[4:7]))
        off += nb
    return p_out, m1, m2


def fused_adamw_leaves_plain(g_leaves, p_leaves, m1_states, m2_states,
                             scalars, *, m1_codec: MomentCodec,
                             m2_codec: MomentCodec, weight_decay: bool):
    """Plain PyTorch version of :func:`fused_adamw_leaves`: the leaves
    concatenated into a zero-padded bucket, :func:`fused_adamw_blocks_plain`
    on it, then the same views."""
    bs = m1_states[0][0].shape[1]
    g = torch.cat([flatten_blocks(x.to(torch.float32), bs) for x in g_leaves])
    p = torch.cat([flatten_blocks(x, bs) for x in p_leaves])
    parts = [torch.cat([st[j] for st in states])
             for states in (m1_states, m2_states) for j in range(3)]
    *_, sumsq = fused_adamw_blocks_plain(
        g, p, *parts, scalars, m1_codec=m1_codec, m2_codec=m2_codec,
        weight_decay=weight_decay)
    return (*_leaf_views(p_leaves, (p, *parts), bs), sumsq)


def fused_adamw_leaves(g_leaves, p_leaves, m1_states, m2_states, scalars, *,
                       m1_codec: MomentCodec, m2_codec: MomentCodec,
                       weight_decay: bool):
    """One fused AdamW step over leaves read where they lie, written into
    one fresh bucket (the inputs are not modified).

    ``p_leaves``: fp32 tensors of any shape; ``g_leaves``: their gradients
    (cast to fp32 where they are not); ``m?_states``: per leaf a (q,
    scale, zero) triple in the blockwise layout, int8 (nb, bs) and fp32
    (nb, 1), ``nb = ceil(numel / bs)``; ``scalars`` as
    :func:`fused_adamw_blocks`.  Returns (new params shaped as the leaves,
    new m1 triples, new m2 triples, update_sumsq): views into the bucket,
    and the sum of (lr * update)^2 over every row (the ragged rows'
    padding included, as the bucket's).

    CPU tensors take :func:`fused_adamw_leaves_plain`; CUDA tensors launch
    the kernel once (one segment a leaf; bs 32, 64, 128 or 256) or raise."""
    dev = p_leaves[0].device
    bs = m1_states[0][0].shape[1]
    for i, (g, p, m1, m2) in enumerate(zip(g_leaves, p_leaves, m1_states,
                                           m2_states, strict=True)):
        nb = -(-p.numel() // bs)
        if (p.dtype != torch.float32 or g.shape != p.shape
                or not p.is_contiguous() or not g.is_contiguous()
                or p.device != dev or g.device != dev):
            raise ValueError(f"fused_adamw_leaves: leaf {i}: p must be a "
                             f"contiguous float32 tensor on {dev} and g a "
                             f"contiguous one of its shape there, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}, g "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")
        for t, dt, shape in ((m1[0], torch.int8, (nb, bs)),
                             (m1[1], torch.float32, (nb, 1)),
                             (m1[2], torch.float32, (nb, 1)),
                             (m2[0], torch.int8, (nb, bs)),
                             (m2[1], torch.float32, (nb, 1)),
                             (m2[2], torch.float32, (nb, 1))):
            if (t.dtype != dt or tuple(t.shape) != shape
                    or not t.is_contiguous() or t.device != dev):
                raise ValueError(f"fused_adamw_leaves: leaf {i}: moment "
                                 f"parts must be contiguous {dt} {shape} on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
    kw = dict(m1_codec=m1_codec, m2_codec=m2_codec,
              weight_decay=weight_decay)
    if dev.type == "cpu":
        return fused_adamw_leaves_plain(g_leaves, p_leaves, m1_states,
                                        m2_states, scalars, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw_leaves: unsupported device {dev}")
    _check_codecs("fused_adamw_leaves", m1_codec, m2_codec, bs)
    if (scalars.dtype != torch.float32 or scalars.device != dev
            or tuple(scalars.shape) != (len(SCALARS),)):
        raise ValueError(f"fused_adamw_leaves: scalars must be float32 "
                         f"({len(SCALARS)},) on {dev}")
    rows = sum(-(-p.numel() // bs) for p in p_leaves)
    out = (torch.empty((rows, bs), dtype=torch.float32, device=dev),
           *(torch.empty(shape, dtype=dt, device=dev)
             for _ in range(2)
             for shape, dt in (((rows, bs), torch.int8),
                               ((rows, 1), torch.float32),
                               ((rows, 1), torch.float32))))
    # held until the launch: a freed cast could give its memory to the
    # update-norm partials
    g32 = [g if g.dtype == torch.float32 else g.to(torch.float32)
           for g in g_leaves]
    sumsq = _launch(
        "fused_adamw_leaves",
        [([g.data_ptr(), p.data_ptr(), *(t.data_ptr() for t in (*m1, *m2))],
          p.numel())
         for g, p, m1, m2 in zip(g32, p_leaves, m1_states, m2_states)],
        out, scalars, bs, m1_codec, m2_codec, weight_decay)
    fused_adamw_leaves.launches += 1
    return (*_leaf_views(p_leaves, out, bs), sumsq)


fused_adamw_blocks.launches = 0
fused_adamw_leaves.launches = 0
