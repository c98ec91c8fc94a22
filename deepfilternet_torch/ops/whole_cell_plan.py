"""The work plan of the whole-cell kernel (`csrc/whole_cell.cu`).

The kernel is one persistent thread block per multiprocessor. A frame is a
fixed list of *phases* with a grid-wide barrier after each; a phase holds the
products ("jobs") that do not depend on one another, and each job is cut into
*units* that are dealt over all blocks: a unit is one tile of `RT` stream rows
by one slice of the job's output columns. This module decides, in plain
Python, what the kernel only executes: the scratch layout, the jobs of each
phase, and each job's slice width for a given stream count and card. The
wrapper uploads the plan as one int32 array. `run_plan` executes the same
table with plain tensor operations, so the CPU tests can hold the schedule
(offsets, phase order, epilogues) against `cell_process_plain` and check that
no job reads what another job of its phase writes.

Activations and state live in a global scratch `[tiles, SCR, RT]` (feature
major inside a tile of 64 streams, so that a K-chunk of a product's input is
one contiguous copy).

The bfloat16 build has a plan of its own (`plan(..., bf16=True)`): it
multiplies on the tensor cores (`mma.sync` m16n8k16), so its K groups are
the four k16 steps of a chunk, and a unit's weight slice is packed in the
order of the B fragments the lanes load, in whole n8 tiles (`pack_weights`;
a slice of 4 or 12 columns is padded with zeros, so that the bfloat16 build
cuts the products into as many units as the float32 one). The kernel rounds each product's input to
bfloat16 as it packs the A fragments, and each job's result where the plain
version's `mm` does (`rnd`, and `kseg` for df_conv0's three window products,
each rounded before they are added); `run_plan` does the same.

The rows design (`csrc/whole_cell_rows.cu`) has no plan; its bfloat16 build
reads every product's weight from a copy packed in the order of the A
fragments (`pack_rows_weights`).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

RT = 64          # stream rows a tile
THREADS = 256    # threads a block (the kernel exports its own for a check)
MAX_CNT = 64     # widest column slice of a unit
KC = 64          # K rows a shared-memory stage
HOP, FPAD, BLK, NB_ERB, NB_DF, HID, CH, ORDER = 480, 512, 128, 32, 96, 256, 16, 5

# scratch columns, in the order of the kernel's `Lay` enum
LAYOUT: List[Tuple[str, int]] = [
    ("buf", 960), ("spec", 1024), ("pow", 512), ("erbwin", 96), ("fswin", 576),
    ("e0", 512), ("e1", 256), ("e2", 128), ("e3", 128), ("c0", 2048), ("c1", 768),
    ("cemb", 128), ("emb", 128), ("xenc", 256), ("emb2", 128), ("xdec", 256), ("xdf", 256),
    ("gh_enc", 768), ("gh_dec", 768), ("gh_df", 3 * 768),
    ("p0", 512), ("p1", 256), ("p2", 128), ("p3", 128),
    ("pa3", 128), ("pa2", 128), ("pa1", 256), ("pa0", 512),
    ("mask", 32), ("coef", 1280), ("se", 1024), ("smem", 480), ("mean", 32), ("unit", 96),
    ("enc_h", 256), ("dec_h", 256), ("df_h", 768), ("ring_re", 512), ("ring_im", 512),
    ("lsnr", 1), ("mute", 1), ("silctr", 1),
]
OFF: Dict[str, int] = {}
_o = 0
for _name, _n in LAYOUT:
    OFF[_name] = _o
    _o += -(-_n // 4) * 4  # every offset stays a multiple of 4 floats (16-byte copies)
SCR = _o

# job types, epilogues and activations, as the kernel's enums
(T_GEMM, T_CARRY_IN, T_FRAME0, T_ADVANCE, T_LSNR, T_CARRY_OUT) = range(6)
(EP_STD, EP_SPEC, EP_ERBNORM, EP_GRU, EP_TAIL, EP_OLA) = range(6)
(ACT_NONE, ACT_RELU, ACT_SIGMOID, ACT_TANH) = range(4)
# where a product's result is rounded with a bfloat16 weight set, as the
# kernel's `Rnd` enum: never (float32 sum, the plain version's `mmf`); the sum
# only, the bias then added in float32 (h @ w_hh, whose bias joins the GRU
# gates); or the sum, then the bias add and the addend add (the model trunk,
# `mm` with its bfloat16 adds)
(R_F32, R_SUM, R_TRUNK) = range(3)
# fields of a job row, as the kernel's `JobField` enum
(J_TYPE, J_BEGIN, J_UNITS, J_XOFF, J_K, J_W, J_NCAT, J_CSTRIDE, J_CW, J_SLICES, J_BIAS, J_ACT,
 J_ADD, J_Y, J_YRAW, J_EP, J_H, J_GH, J_KG, J_AUX, J_RND, J_KSEG) = range(22)
JOB_INTS = 22
PHASE_INTS = 3   # first job, jobs, units
(H_PHASES, H_JOBS, H_TILES, H_FRAME_PHASES, H_PRE, H_SEGS, H_LAY, H_SCR) = range(8)
HEADER_INTS = 8
EW_CHUNKS = 16   # units a tile for the elementwise jobs that are cut by column
# what a unit costs beside its multiply-adds, in columns: the input tile it
# streams in whatever its width
UNIT_OVERHEAD_COLS = 8


class Gemm(NamedTuple):
    """y[:, cols] = act(x @ [w0; w1; w2] + bias) (+ addend), per tile of rows.
    The output columns are `ncat` groups of `n` columns, `cat_stride` apart
    in the weight (re | im of the DFT, the three gates of a GRU, the two hops
    of the synthesis frame): a unit owns the same `cw` columns of every
    group, so its epilogue sees them together. x, y, add, yraw, h, gh are
    scratch columns (name, or (name, offset)). `rnd`: where a bfloat16
    weight set rounds the result (R_*); `kseg`: K rows of each input segment
    whose product is rounded before the segments are added (0: one sum)."""

    name: str
    x: object
    k: int
    w: Tuple[str, ...]
    n: int
    y: object = None
    bias: Optional[str] = None
    act: int = ACT_NONE
    add: object = None
    yraw: object = None
    ep: int = EP_STD
    ncat: int = 1
    cat_stride: int = 0
    h: object = None
    gh: object = None
    rnd: int = R_TRUNK
    kseg: int = 0


class Packed(NamedTuple):
    """Where a product's weight lies in the packed buffer, and how it is cut."""

    keys: Tuple[str, ...]   # weight keys stacked along K ("dft_t": the transposed `dft`)
    k: int
    ncat: int
    cat_stride: int
    n: int                  # columns of each group
    cw: int                 # columns of each group a unit owns
    offset: int             # first float in the packed buffer


class Elementwise(NamedTuple):
    name: str
    type: int
    chunks: int


def _col(ref) -> int:
    if ref is None:
        return -1
    if isinstance(ref, tuple):
        return OFF[ref[0]] + ref[1]
    return OFF[ref]


def _gru(name, x, layer_keys, h, gh):
    wih, bih = layer_keys
    return Gemm(name, x, HID, (wih,), HID, bias=bih, ep=EP_GRU, ncat=3, cat_stride=HID,
                h=h, gh=gh)


def frame_phases() -> List[Tuple[str, list]]:
    """The phases of one frame: (stage name, jobs). A job reads only what an
    earlier phase (or the last frame) wrote; jobs of one phase write disjoint
    scratch columns and none reads what another of the same phase writes."""
    R, SG, TH = ACT_RELU, ACT_SIGMOID, ACT_TANH
    F32 = R_F32
    gh = [Gemm("enc_whh", "enc_h", HID, ("enc_whh",), 768, "gh_enc", "enc_bhh", rnd=R_SUM),
          Gemm("dec_whh", "dec_h", HID, ("dec_whh",), 768, "gh_dec", "dec_bhh", rnd=R_SUM)]
    gh += [Gemm(f"df_whh{i}", ("df_h", HID * i), HID, (f"df_whh{i}",), 768,
                ("gh_df", 768 * i), f"df_bhh{i}", rnd=R_SUM) for i in range(3)]
    return [
        ("analysis DFT, h @ w_hh", [
            Gemm("dft", "buf", 960, ("dft",), FPAD, ep=EP_SPEC, ncat=2, cat_stride=FPAD,
                 rnd=F32)] + gh),
        ("erb bands, df_conv0", [
            Gemm("erb_fwd", "pow", FPAD, ("erb_fwd",), NB_ERB, ep=EP_ERBNORM, rnd=F32),
            Gemm("c0", "fswin", 576, ("c0w_t0", "c0w_t1", "c0w_t2"), 2048, "c0", "c0_b", R,
                 kseg=2 * NB_DF)]),
        ("e0, df_conv1", [
            Gemm("e0", "erbwin", 96, ("e0_w",), 512, "e0", "e0_b", R),
            Gemm("c1", "c0", 2048, ("c1_w",), 768, "c1", "c1_b", R)]),
        ("e1, df_fc_emb, p0", [
            Gemm("e1", "e0", 512, ("e1_w",), 256, "e1", "e1_b", R),
            Gemm("gl", "c1", 768, ("gl_w",), 128, "cemb", None, R),
            Gemm("p0", "e0", 512, ("p0_w",), 512, "p0", "p0_b", R)]),
        ("e2, p1", [
            Gemm("e2", "e1", 256, ("e2_w",), 128, "e2", "e2_b", R),
            Gemm("p1", "e1", 256, ("p1_w",), 256, "p1", "p1_b", R)]),
        ("e3, p2", [
            Gemm("e3", "e2", 128, ("e3_w",), 128, "emb", "e3_b", R, add="cemb", yraw="e3"),
            Gemm("p2", "e2", 128, ("p2_w",), 128, "p2", "p2_b", R)]),
        ("enc lin_in, p3", [
            Gemm("enc_lin_in", "emb", 128, ("enc_lin_in",), HID, "xenc", None, R),
            Gemm("p3", "e3", 128, ("p3_w",), 128, "p3", "p3_b", R)]),
        ("enc GRU", [_gru("enc_gru", "xenc", ("enc_wih", "enc_bih"), "enc_h", "gh_enc")]),
        ("enc lin_out", [
            Gemm("enc_lin_out", "enc_h", HID, ("enc_lin_out",), 128, "emb2", None, R)]),
        ("dec/df lin_in, lsnr", [
            Gemm("dec_lin_in", "emb2", 128, ("dec_lin_in",), HID, "xdec", None, R),
            Gemm("df_lin_in", "emb2", 128, ("df_lin_in",), HID, "xdf", None, R),
            Elementwise("lsnr", T_LSNR, 1)]),
        ("dec GRU, df GRU 0", [
            _gru("dec_gru", "xdec", ("dec_wih", "dec_bih"), "dec_h", "gh_dec"),
            _gru("df_gru0", "xdf", ("df_wih0", "df_bih0"), "df_h", "gh_df")]),
        ("dec lin_out, df GRU 1", [
            Gemm("dec_lin_out", "dec_h", HID, ("dec_lin_out",), 128, "pa3", None, R, add="p3"),
            _gru("df_gru1", "df_h", ("df_wih1", "df_bih1"), ("df_h", HID), ("gh_df", 768))]),
        ("convt3, df GRU 2", [
            Gemm("t3", "pa3", 128, ("t3_w",), 128, "pa2", "t3_b", R, add="p2"),
            _gru("df_gru2", ("df_h", HID), ("df_wih2", "df_bih2"), ("df_h", 2 * HID),
                 ("gh_df", 2 * 768))]),
        ("convt2, df_out", [
            Gemm("t2", "pa2", 128, ("t2_w",), 256, "pa1", "t2_b", R, add="p1"),
            Gemm("df_out", ("df_h", 2 * HID), HID, ("df_out_w",), ORDER * 2 * BLK, "coef", None,
                 TH, rnd=F32)]),
        ("convt1", [Gemm("t1", "pa1", 256, ("t1_w",), 512, "pa0", "t1_b", R, add="p0")]),
        ("conv_out mask", [Gemm("out", "pa0", 512, ("out_w",), NB_ERB, "mask", "out_b", SG,
                                rnd=F32)]),
        ("mask gains, DF MAC, tail", [Gemm("erb_inv", "mask", NB_ERB, ("erb_inv",), FPAD,
                                           ep=EP_TAIL, rnd=F32)]),
        ("synthesis, overlap-add, advance", [
            Gemm("synthesis", "se", 2 * FPAD, ("dft_t",), HOP, ep=EP_OLA, ncat=2, cat_stride=HOP,
                 rnd=F32),
            Elementwise("advance", T_ADVANCE, EW_CHUNKS)]),
    ]


PRE_PHASES = [("carry in", [Elementwise("carry_in", T_CARRY_IN, EW_CHUNKS)]),
              ("first frame in", [Elementwise("frame0", T_FRAME0, EW_CHUNKS)])]
POST_PHASE = ("carry out", [Elementwise("carry_out", T_CARRY_OUT, EW_CHUNKS)])

# names of `cell_process.stage_clocks`' entries: block 0's cycles in each phase
# of the frame, then its cycles waiting at the grid barriers
STAGES: Tuple[str, ...] = tuple(n for n, _ in frame_phases()) + ("grid barriers",)

CKEY_ORDER = ("amem", "smem", "norms", "sil", "erb_ctx", "spec_ctx", "enc_h", "dec_h", "df_h",
              "ring_re", "ring_im")
# carry array <-> scratch columns: (carry key, first carry column, length, scratch column)
CARRY_SEGMENTS: List[Tuple[str, int, int, int]] = [
    ("amem", 0, 480, OFF["buf"]), ("smem", 0, 480, OFF["smem"]),
    ("norms", 0, 32, OFF["mean"]), ("norms", 32, 96, OFF["unit"]),
    ("sil", 0, 1, OFF["silctr"]),
    ("erb_ctx", 0, 64, OFF["erbwin"]),
    # spec_ctx is (c, t, f) flat; the window holds frames as [re | im] pairs
    ("spec_ctx", 0, 96, OFF["fswin"]), ("spec_ctx", 96, 96, OFF["fswin"] + 192),
    ("spec_ctx", 192, 96, OFF["fswin"] + 96), ("spec_ctx", 288, 96, OFF["fswin"] + 288),
    ("enc_h", 0, 256, OFF["enc_h"]), ("dec_h", 0, 256, OFF["dec_h"]),
    ("df_h", 0, 768, OFF["df_h"]),
    ("ring_re", 0, 512, OFF["ring_re"]), ("ring_im", 0, 512, OFF["ring_im"]),
]


def _widths(job: Gemm) -> List[int]:
    """Slice widths (columns of each group) a unit of this job may own."""
    return [cw for cw in (4, 8, 16, 32, 64) if job.n % cw == 0 and job.ncat * cw <= MAX_CNT]


def packed_cols(cnt: int, bf16: bool) -> int:
    """Columns of a unit's packed weight slice: its own, or in the bfloat16
    build whole n8 tiles of the tensor cores (a slice of 4 or 12 columns is
    padded with zero columns, which the kernel multiplies and never stores)."""
    return -(-cnt // 8) * 8 if bf16 else cnt


def _micro_cols(cnt: int) -> int:
    """Columns of a thread's register tile (8 rows x this): 8 where the unit's
    slice is wide enough to keep the threads busy, else 2."""
    return 8 if cnt % 8 == 0 and cnt >= 16 else 2


# the bfloat16 build's K groups: warp w multiplies the k16 step w // 2 of
# every chunk (for the rows of half w % 2 of the tile)
MMA_K_GROUPS = KC // 16


def _k_groups(cnt: int) -> int:
    """Thread groups that split a chunk's K rows in the float32 build: a
    group is 8 row groups x cnt / micro-tile columns; a power of two, so that
    it divides a chunk of 32 rows."""
    per_group = 8 * cnt // _micro_cols(cnt)
    kg = 1
    while kg * 2 * per_group <= THREADS and kg < 16:
        kg *= 2
    return kg


def _unit_cost(job: Gemm, cw: int) -> int:
    return job.k * (job.ncat * cw + UNIT_OVERHEAD_COLS)


def _choose_widths(gemms: List[Gemm], tiles: int, n_blocks: int) -> List[int]:
    """A slice width per job of a phase: the widest slices whose share of the
    phase stays near one block's, picked by dealing the units over the blocks
    as the kernel does (unit u to block u mod n_blocks) for a few candidate
    shares and keeping the one whose busiest block is done first."""
    if not gemms:
        return []
    widths = [_widths(j) for j in gemms]
    total = sum(_unit_cost(j, w[-1]) * (j.n // w[-1]) for j, w in zip(gemms, widths)) * tiles
    best = None
    for f in (0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0, 1e9):
        share = total / n_blocks * f
        cws = []
        for j, w in zip(gemms, widths):
            ok = [cw for cw in w if _unit_cost(j, cw) <= share]
            cws.append(ok[-1] if ok else w[0])
        load = np.zeros(n_blocks)
        u = 0
        for j, cw in zip(gemms, cws):
            n_units = (j.n // cw) * tiles
            idx = (u + np.arange(n_units)) % n_blocks
            np.add.at(load, idx, _unit_cost(j, cw))
            u += n_units
        span = float(load.max())
        if best is None or span < best[0]:
            best = (span, cws)
    return best[1]


def plan(s: int, n_blocks: int, bf16: bool = False):
    """The plan for S streams on n_blocks persistent blocks (one per
    multiprocessor), for the float32 build or (`bf16`) the bfloat16 one.

    Returns (table, info): `table` the int32 array the kernel reads (header,
    scratch offsets, carry segments, phases, jobs), `info` a dict with
    `tiles`, `blocks`, `scratch_shape`, `n_stages`, `phases` (per phase a
    list of (job name, cw, kg, units)) and `packing`, `pack_floats` for
    `pack_weights`; `bf16`."""
    from deepfilternet_torch.ops.whole_cell import WKEYS

    tiles = -(-s // RT)
    wid = {k: i for i, k in enumerate(WKEYS)}
    packing, pack_floats = [], 0
    frame = frame_phases()
    phases = PRE_PHASES + frame + [POST_PHASE]
    ph_rows, job_rows, info_ph = [], [], []
    for pi, (_, jobs) in enumerate(phases):
        gemms = [j for j in jobs if isinstance(j, Gemm)]
        cws = dict(zip((j.name for j in gemms), _choose_widths(gemms, tiles, n_blocks)))
        begin, first, rows = 0, len(job_rows), []
        for j in jobs:
            r = [0] * JOB_INTS
            if isinstance(j, Gemm):
                cw = cws[j.name]
                # the float32 build's register tile; 0: the bfloat16 build's mma
                kg, mc = ((MMA_K_GROUPS, 0) if bf16 else
                          (_k_groups(cw * j.ncat), _micro_cols(cw * j.ncat)))
                assert j.k % 32 == 0 and j.kseg % KC == 0 and (j.kseg == 0 or j.k % j.kseg == 0), \
                    j.name
                units = (j.n // cw) * tiles
                packing.append(Packed(j.w, j.k, j.ncat, j.cat_stride, j.n, cw, pack_floats))
                r[:] = [T_GEMM, begin, units, _col(j.x), j.k, pack_floats, j.ncat,
                        j.cat_stride, cw, j.n // cw, wid[j.bias] if j.bias else -1, j.act,
                        _col(j.add), _col(j.y), _col(j.yraw), j.ep, _col(j.h), _col(j.gh), kg,
                        mc, j.rnd, j.kseg]
                pack_floats += units // tiles * j.k * packed_cols(cw * j.ncat, bf16)
                rows.append((j.name, cw, kg, units))
            else:
                units = j.chunks * tiles
                r[J_TYPE], r[J_BEGIN], r[J_UNITS], r[J_AUX] = j.type, begin, units, j.chunks
                rows.append((j.name, 0, 0, units))
            begin += units
            job_rows.append(r)
        ph_rows.append([first, len(jobs), begin])
        info_ph.append(rows)
    lay = [OFF[n] for n, _ in LAYOUT]
    segs = [[CKEY_ORDER.index(k), a, n, o] for k, a, n, o in CARRY_SEGMENTS]
    header = [len(phases), len(job_rows), tiles, len(frame), len(PRE_PHASES), len(segs),
              len(lay), SCR]
    table = np.asarray(header + lay + sum(segs, []) + sum(ph_rows, []) + sum(job_rows, []),
                       np.int32)
    info = dict(tiles=tiles, blocks=n_blocks, scratch_shape=(tiles, SCR, RT),
                n_stages=len(STAGES), phases=info_ph, packing=packing,
                pack_floats=pack_floats, bf16=bf16)
    return table, info


def _fragment_order(rows: int, cols: int, regs: int) -> torch.Tensor:
    """Where each value an m16n8k16 operand fragment holds lies in its
    [16 (k), cols] block: lane l (g = l // 4, t = l % 4) holds `regs` 32-bit
    registers of two k-neighbours each, at k = 2t (+1) for the even register
    pairs and 2t + 8 (+9) for the odd ones, and at column g, or g + 8 in the
    A fragment's registers 1 and 3 (`rows` = 16; the B fragment has 8
    columns). Returns the block's flat indices in lane order, `regs` * 2
    values a lane."""
    e = torch.arange(2 * regs)[None]
    g, t = torch.arange(32)[:, None] // 4, torch.arange(32)[:, None] % 4
    k = 2 * t + (e & 1) + 8 * (e >> (2 if rows == 16 else 1))
    col = g + (8 * ((e >> 1) & 1) if rows == 16 else 0)
    return (k * cols + col).reshape(-1)


# B fragment of a k16 x n8 block (units: the weight slice's columns);
# A fragment of an m16 x k16 block of W^T (rows: 16 output columns)
B_ORDER = _fragment_order(8, 8, 2)
A_ORDER = _fragment_order(16, 16, 4)


def pack_weights(weights: Dict[str, torch.Tensor], info: dict) -> torch.Tensor:
    """Every product's weight, laid out for this plan's units: for each
    product `[slices, K, ncat * cw]` (a unit's slice of the weight contiguous,
    K rows of its `ncat * cw` columns), one after the other in one buffer. A
    unit's K-chunk is then one contiguous copy, and no block reads narrow
    strips of wide rows. The synthesis product's weight is `dft` transposed.
    For the bfloat16 plan each slice's [K, cnt], padded with zero columns to
    whole n8 tiles (`packed_cols`), is in the order of the tensor cores' B
    fragments instead: `[K / 16][n8 tiles][32 lanes][4]`, so that a lane's
    fragment of a (k16 step, n8 tile) is one 8-byte load.
    The buffer has the products' operand type (`dft`'s: float32 or bfloat16;
    offsets count elements). The weight set itself is left as it is (it
    compares with the JAX package key by key); this is a private copy of the
    kernel wrapper."""
    dev = weights["dft"].device
    if info["bf16"] and weights["dft"].dtype != torch.bfloat16:
        raise TypeError("the bfloat16 plan packs bfloat16 weights only")
    out = torch.empty((info["pack_floats"],), dtype=weights["dft"].dtype, device=dev)
    for pk in info["packing"]:
        w = torch.cat([weights["dft"].T if k == "dft_t" else weights[k] for k in pk.keys], dim=0)
        assert w.shape[0] == pk.k
        cats = torch.stack([w[:, c * pk.cat_stride: c * pk.cat_stride + pk.n]
                            for c in range(pk.ncat)], dim=1)          # [K, ncat, n]
        tiled = cats.reshape(pk.k, pk.ncat, pk.n // pk.cw, pk.cw).permute(2, 0, 1, 3)
        if info["bf16"]:
            cnt = pk.ncat * pk.cw
            cp = packed_cols(cnt, True)
            tiled = torch.nn.functional.pad(tiled.reshape(-1, pk.k, cnt), (0, cp - cnt))
            blocks = tiled.reshape(-1, pk.k // 16, 16, cp // 8, 8).permute(0, 1, 3, 2, 4)
            tiled = blocks.reshape(-1, pk.k // 16, cp // 8, 128)[..., B_ORDER.to(dev)]
        out[pk.offset: pk.offset + tiled.numel()] = tiled.reshape(-1)
    return out


def unpack_weight(packed: torch.Tensor, job: np.ndarray) -> torch.Tensor:
    """A product job's weight as [K, ncat, n], read back from the packed
    buffer the way the kernel addresses it (for the tests and `run_plan`)."""
    k, ncat, cw, n_slices = (int(job[i]) for i in (J_K, J_NCAT, J_CW, J_SLICES))
    off, cnt = int(job[J_W]), ncat * cw
    if int(job[J_AUX]) == 0:  # the bfloat16 plan: B fragment order, whole n8 tiles
        cp = packed_cols(cnt, True)
        frag = packed[off: off + n_slices * k * cp].reshape(n_slices, k // 16, cp // 8, 128)
        blocks = torch.empty_like(frag)
        blocks[..., B_ORDER.to(packed.device)] = frag
        t = blocks.reshape(n_slices, k // 16, cp // 8, 16, 8).permute(0, 1, 3, 2, 4)
        t = t.reshape(n_slices, k, cp)[..., :cnt]
    else:
        t = packed[off: off + n_slices * k * cnt]
    t = t.reshape(n_slices, k, ncat, cw)
    return t.permute(1, 2, 0, 3).reshape(k, ncat, n_slices * cw)


# the rows design's products, each a tuple of weight keys stacked along K
# (df_conv0's three window products are one product of three segments)
ROWS_PRODUCTS: Tuple[Tuple[str, ...], ...] = tuple(
    j.w for _, jobs in frame_phases() for j in jobs if isinstance(j, Gemm))


def pack_rows_weights(weights: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, List[int]]:
    """The bfloat16 rows build's copy of every product's weight W [K, N], in
    the order of the tensor cores' A fragments of W^T: `[N / 16][K / 16][32
    lanes][8]`, so that a lane's fragment of (16 output columns, k16 step)
    is one 16-byte load and a warp walks a column tile's K steps through
    contiguous memory. Returns (buffer, offsets): offsets[i] is where the
    product whose first key is WKEYS[i] starts (index len(WKEYS): the
    synthesis product against `dft` transposed), -1 for the keys that start
    none."""
    from deepfilternet_torch.ops.whole_cell import WKEYS

    if weights["dft"].dtype != torch.bfloat16:
        raise TypeError("the rows design packs bfloat16 weights only")
    dev = weights["dft"].device
    offsets, parts, off = [-1] * (len(WKEYS) + 1), [], 0
    for keys in ROWS_PRODUCTS:
        w = torch.cat([weights["dft"].T if k == "dft_t" else weights[k] for k in keys], dim=0)
        k, n = w.shape
        blocks = w.reshape(k // 16, 16, n // 16, 16).permute(2, 0, 1, 3)
        parts.append(blocks.reshape(n // 16, k // 16, 256)[..., A_ORDER.to(dev)].reshape(-1))
        offsets[len(WKEYS) if keys == ("dft_t",) else WKEYS.index(keys[0])] = off
        off += k * n
    return torch.cat(parts), offsets


@functools.lru_cache(maxsize=None)
def cached_plan(s: int, n_blocks: int, bf16: bool = False):
    return plan(s, n_blocks, bf16)


class Table(NamedTuple):
    """A plan table cut back into its parts, the way the kernel reads it."""

    header: np.ndarray
    lay: np.ndarray
    segs: np.ndarray
    phases: np.ndarray
    jobs: np.ndarray


def decode(table: np.ndarray) -> Table:
    h = table[:HEADER_INTS]
    a = HEADER_INTS
    lay = table[a: a + h[H_LAY]]
    a += h[H_LAY]
    segs = table[a: a + 4 * h[H_SEGS]].reshape(-1, 4)
    a += 4 * h[H_SEGS]
    phases = table[a: a + PHASE_INTS * h[H_PHASES]].reshape(-1, PHASE_INTS)
    a += PHASE_INTS * h[H_PHASES]
    jobs = table[a:].reshape(-1, JOB_INTS)
    assert len(jobs) == h[H_JOBS]
    return Table(h, lay, segs, phases, jobs)


def unit_columns(job: np.ndarray, unit: int, tiles: int) -> Tuple[int, List[int]]:
    """(tile, output columns of the weight) of a product job's unit, decoded
    as the kernel decodes it."""
    local = unit - int(job[J_BEGIN])
    tile, sl = local % tiles, local // tiles
    ncat, stride, cw = int(job[J_NCAT]), int(job[J_CSTRIDE]), int(job[J_CW])
    return tile, [c * stride + sl * cw + i for c in range(ncat) for i in range(cw)]


# ---------------------------------------------------------------------------
# the plan executed with plain tensor operations (for the CPU tests)
# ---------------------------------------------------------------------------


class _Scratch:
    """[S, SCR] scratch that records which columns each job reads and writes."""

    def __init__(self, s: int):
        self.a = torch.zeros((s, SCR), dtype=torch.float32)
        self.reads: Dict[str, set] = {}
        self.writes: Dict[str, set] = {}
        self.job = ""

    def rd(self, col: int, n: int) -> torch.Tensor:
        self.reads.setdefault(self.job, set()).update(range(col, col + n))
        return self.a[:, col: col + n].clone()

    def wr(self, col: int, val: torch.Tensor) -> None:
        self.writes.setdefault(self.job, set()).update(range(col, col + val.shape[1]))
        self.a[:, col: col + val.shape[1]] = val


def _act(v, act):
    return {ACT_NONE: lambda x: x, ACT_RELU: torch.relu, ACT_SIGMOID: torch.sigmoid,
            ACT_TANH: torch.tanh}[act](v)


def run_plan(table: np.ndarray, audio: torch.Tensor, carry: Dict[str, torch.Tensor],
             weights: Dict[str, torch.Tensor], statics, packed: torch.Tensor,
             hazards: Optional[list] = None):
    """Execute a plan table on the CPU: every phase in order, every job whole
    (all its units at once) on its weight from the packed buffer
    (`pack_weights`), every epilogue as the kernel writes it, and with a
    bfloat16 buffer every rounding as the kernel rounds. Returns
    (new carry, enhanced audio) like `cell_process`. `hazards` collects
    (phase, job a, job b) for every pair of jobs of one phase where a reads
    or writes columns that b writes."""
    from deepfilternet_torch.ops.whole_cell import WKEYS

    t = decode(table)
    L = {name: int(t.lay[i]) for i, (name, _) in enumerate(LAYOUT)}
    s, total = audio.shape
    n_frames = total // HOP
    W = [weights[k].float() for k in WKEYS]
    wf = dict(zip(WKEYS, W))
    bf16 = packed.dtype == torch.bfloat16

    def rb(v):  # a result rounded to the operand type
        return v.to(torch.bfloat16).float() if bf16 else v

    sc = _Scratch(s)
    out = torch.zeros_like(audio)
    new_carry = {k: torch.zeros_like(v) for k, v in carry.items()}
    st = statics
    a = st.alpha

    def frame_in(f, shift):
        if shift:
            sc.wr(L["buf"], sc.rd(L["buf"] + HOP, HOP))
            sc.wr(L["fswin"], sc.rd(L["fswin"] + 192, 384))
            sc.wr(L["erbwin"], sc.rd(L["erbwin"] + NB_ERB, 2 * NB_ERB))
        if f >= n_frames:
            return
        fr = audio[:, f * HOP: (f + 1) * HOP]
        sc.wr(L["buf"] + HOP, fr)
        rms = torch.sqrt(torch.mean(fr * fr, dim=-1, keepdim=True))
        ctr = torch.where(rms < st.silence_thresh, sc.rd(L["silctr"], 1) + 1.0,
                          torch.zeros_like(rms))
        sc.wr(L["silctr"], ctr)
        sc.wr(L["mute"], (ctr >= st.silence_frames).to(torch.float32))

    def gemm(j, f):
        k, ncat = int(j[J_K]), int(j[J_NCAT])
        n = int(j[J_CW]) * int(j[J_SLICES])
        w = unpack_weight(packed, j).float()
        x = rb(sc.rd(int(j[J_XOFF]), k))  # trunk products' values are exact in it
        rnd = int(j[J_RND]) if bf16 else R_F32
        kseg = int(j[J_KSEG]) if bf16 else 0
        if kseg:  # each segment's product rounded, then added with rounding
            cats = []
            for c in range(ncat):
                tot = None
                for k0 in range(0, k, kseg):
                    part = rb(x[:, k0: k0 + kseg] @ w[k0: k0 + kseg, c])
                    tot = part if tot is None else rb(tot + part)
                cats.append(tot)
        else:
            cats = [x @ w[:, c] for c in range(ncat)]
        if rnd != R_F32:
            cats = [rb(v) for v in cats]
        bias = W[int(j[J_BIAS])].reshape(-1) if j[J_BIAS] >= 0 else None
        trunk = rb if rnd == R_TRUNK else (lambda v: v)
        ep = int(j[J_EP])
        if ep == EP_STD:
            v = cats[0] if bias is None else trunk(cats[0] + bias[:n])
            v = _act(v, int(j[J_ACT]))
            if j[J_YRAW] >= 0:
                sc.wr(int(j[J_YRAW]), v)
            if j[J_ADD] >= 0:
                v = trunk(v + sc.rd(int(j[J_ADD]), n))
            sc.wr(int(j[J_Y]), v)
        elif ep == EP_SPEC:
            re, im = cats
            pw = re * re + im * im
            sc.wr(L["spec"], re)
            sc.wr(L["spec"] + FPAD, im)
            sc.wr(L["pow"], pw)
            un = torch.sqrt(pw[:, :NB_DF]) * (1.0 - a) + sc.rd(L["unit"], NB_DF) * a
            sc.wr(L["unit"], un)
            scale = torch.rsqrt(un)
            sc.wr(L["fswin"] + 384, re[:, :NB_DF] * scale)
            sc.wr(L["fswin"] + 384 + NB_DF, im[:, :NB_DF] * scale)
        elif ep == EP_ERBNORM:
            db = 10.0 * torch.log10(cats[0] + 1e-10)
            mean = db * (1.0 - a) + sc.rd(L["mean"], n) * a
            sc.wr(L["mean"], mean)
            sc.wr(L["erbwin"] + 64, (db - mean) / 40.0)
        elif ep == EP_GRU:
            gi = [trunk(cats[c] + bias[c * HID: c * HID + n]) for c in range(3)]
            gh = [sc.rd(int(j[J_GH]) + c * HID, n) for c in range(3)]
            h = sc.rd(int(j[J_H]), n)
            r = torch.sigmoid(gi[0] + gh[0])
            z = torch.sigmoid(gi[1] + gh[1])
            ng = torch.tanh(gi[2] + r * gh[2])
            sc.wr(int(j[J_H]), (1.0 - z) * ng + z * h)
        elif ep == EP_TAIL:
            g = cats[0]
            re, im = sc.rd(L["spec"], FPAD), sc.rd(L["spec"] + FPAD, FPAD)
            m_re, m_im = re * g, im * g
            lane = (torch.arange(BLK) < NB_DF).to(torch.float32)[None]
            cur_re, cur_im = re[:, :BLK] * lane, im[:, :BLK] * lane
            c0 = sc.rd(L["c0"], CH * BLK).reshape(s, CH, BLK)
            ring_re = sc.rd(L["ring_re"], 4 * BLK).reshape(s, 4, BLK)
            ring_im = sc.rd(L["ring_im"], 4 * BLK).reshape(s, 4, BLK)
            coef = sc.rd(L["coef"], ORDER * 2 * BLK).reshape(s, ORDER * 2, BLK)
            cp = torch.einsum("co,scf->sof", wf["convp_co"], c0)
            cb = wf["convp_b"][0]
            y_re = torch.zeros((s, BLK))
            y_im = torch.zeros((s, BLK))
            for n_ in range(ORDER):
                t_re = ring_re[:, n_] if n_ < ORDER - 1 else cur_re
                t_im = ring_im[:, n_] if n_ < ORDER - 1 else cur_im
                c_re = coef[:, 2 * n_] + torch.relu(cp[:, 2 * n_] + cb[2 * n_])
                c_im = coef[:, 2 * n_ + 1] + torch.relu(cp[:, 2 * n_ + 1] + cb[2 * n_ + 1])
                y_re = y_re + t_re * c_re - t_im * c_im
                y_im = y_im + t_re * c_im + t_im * c_re
            sc.wr(L["ring_re"], torch.cat([ring_re[:, 1:].reshape(s, -1), cur_re], dim=1))
            sc.wr(L["ring_im"], torch.cat([ring_im[:, 1:].reshape(s, -1), cur_im], dim=1))
            se_re = torch.cat([y_re[:, :NB_DF], m_re[:, NB_DF:]], dim=1)
            se_im = torch.cat([y_im[:, :NB_DF], m_im[:, NB_DF:]], dim=1)
            if st.mask_pf:
                eps = 1e-12
                mag_e = torch.sqrt(se_re**2 + se_im**2)
                mag_x = torch.sqrt(re**2 + im**2)
                gg = torch.clamp(mag_e / (mag_x + eps), eps, 1.0)
                g_sin = torch.clamp(gg * torch.sin(np.pi * gg / 2.0), min=eps)
                pf = (1.0 + st.pf_beta) / (1.0 + st.pf_beta * (gg / g_sin) ** 2)
                se_re, se_im = se_re * pf, se_im * pf
            if st.lsnr_gating:
                ls = sc.rd(L["lsnr"], 1)
                below = ls < st.gate_lsnr_min
                erb_only = (ls > st.gate_lsnr_max_df) & (ls <= st.gate_lsnr_max_erb)
                bypass = ls > st.gate_lsnr_max_erb
                zero = torch.zeros_like(se_re)
                se_re = torch.where(below, zero, torch.where(
                    erb_only, m_re, torch.where(bypass, re, se_re)))
                se_im = torch.where(below, zero, torch.where(
                    erb_only, m_im, torch.where(bypass, im, se_im)))
            if st.atten_lim > 0.0:
                se_re = re * st.atten_lim + se_re * (1.0 - st.atten_lim)
                se_im = im * st.atten_lim + se_im * (1.0 - st.atten_lim)
            mute = sc.rd(L["mute"], 1) != 0
            se_re = torch.where(mute, torch.zeros_like(se_re), se_re)
            se_im = torch.where(mute, torch.zeros_like(se_im), se_im)
            sc.wr(L["se"], se_re * wf["imult"])
            sc.wr(L["se"] + FPAD, se_im * wf["imult"])
        elif ep == EP_OLA:
            out[:, f * HOP: (f + 1) * HOP] = cats[0] + sc.rd(L["smem"], HOP)
            sc.wr(L["smem"], cats[1])

    def run_phase(pi, f):
        first, count = int(t.phases[pi][0]), int(t.phases[pi][1])
        sc.reads.clear()
        sc.writes.clear()
        for ji in range(first, first + count):
            j = t.jobs[ji]
            sc.job = f"job {ji}"
            ty = int(j[J_TYPE])
            if ty == T_GEMM:
                gemm(j, f)
            elif ty == T_CARRY_IN:
                for key, cs, n, so in t.segs:
                    sc.wr(int(so), carry[CKEY_ORDER[key]][:, cs: cs + n])
            elif ty == T_FRAME0:
                frame_in(0, False)
            elif ty == T_ADVANCE:
                frame_in(f + 1, True)
            elif ty == T_LSNR:
                e = rb(sc.rd(L["emb2"], 128))
                ls = torch.sigmoid(e @ wf["lsnr_w"] + wf["lsnr_b"])
                sc.wr(L["lsnr"], ls * (st.lsnr_max - st.lsnr_min) + st.lsnr_min)
            elif ty == T_CARRY_OUT:
                for key, cs, n, so in t.segs:
                    new_carry[CKEY_ORDER[key]][:, cs: cs + n] = sc.rd(int(so), int(n))
                new_carry["sil"][:, 1:] = carry["sil"][:, 1:]
        if hazards is not None:
            names = list(sc.writes)
            for b in names:
                for other in set(sc.reads) | set(sc.writes):
                    if other == b:
                        continue
                    touched = sc.reads.get(other, set()) | sc.writes.get(other, set())
                    if touched & sc.writes[b]:
                        hazards.append((pi, other, b))

    n_pre, n_fp = int(t.header[H_PRE]), int(t.header[H_FRAME_PHASES])
    for pi in range(n_pre):
        run_phase(pi, 0)
    for f in range(n_frames):
        for pi in range(n_fp):
            run_phase(n_pre + pi, f)
    run_phase(n_pre + n_fp, 0)
    return new_carry, out
