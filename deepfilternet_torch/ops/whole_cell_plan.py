"""The work plan of the whole-cell kernel (`csrc/whole_cell.cu`).

The kernel is one persistent thread block per multiprocessor. A frame is a
fixed list of *phases*; a phase holds the products ("jobs") that do not
depend on one another, and each job is cut into *units* that are dealt over
all blocks: a unit is one tile of `RT` stream rows by one slice of the job's
output columns. The units of a launch have one global order, frame by frame
and in phase order (`unit_order`), and every block walks its own units in
that order. No barrier separates the phases: from the scratch columns each
job reads and writes, the plan derives the edges between jobs (`edges`:
read after write, write after read, write after write; within the frame or
from the frame before), keeps those no other path implies, and every edge
points backward in the global order. A unit waits only until each of its
producers' counters (one per job and tile of 64 streams) has counted that
producer's units up to the frame it needs; so, with all blocks resident,
the order cannot deadlock. This module decides, in plain Python, what the
kernel only executes: the scratch layout, the jobs of each phase, each job's
slice width for a given stream count and card, and the edges. The wrapper
uploads the plan as one int32 array. `run_plan` executes the same table
with plain tensor operations, so the CPU tests can hold the schedule
(offsets, order, epilogues, edges) against `cell_process_plain`: job by job
in phase order, or unit by unit in any order the edges allow, checking
that every read finds the value the phase order would have left there.

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
 J_ADD, J_Y, J_YRAW, J_EP, J_H, J_GH, J_KG, J_AUX, J_RND, J_KSEG, J_DEP0, J_NDEP) = range(24)
JOB_INTS = 24
PHASE_INTS = 3   # first job, jobs, units
# a row of the edges, as the kernel's `DepField` enum: the producer's job row,
# its units a tile in a frame, and the frame it is waited for in (0: this
# frame, -1: the frame before)
(D_JOB, D_PER_TILE, D_FRAME) = range(3)
DEP_INTS = 3
(H_PHASES, H_JOBS, H_TILES, H_FRAME_PHASES, H_PRE, H_SEGS, H_LAY, H_SCR, H_DEPS) = range(9)
HEADER_INTS = 9
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

# the stages a block of the units design times (utils.timings.k2_records): its
# time in the units of each phase of the frame, then its time waiting on
# producers (from a unit's start until its first input stage is in, or, for
# an elementwise unit, until its producers' counters are reached)
WAIT_STAGE = "waiting on producers"
STAGES: Tuple[str, ...] = tuple(n for n, _ in frame_phases()) + (WAIT_STAGE,)

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


def job_access(job: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(reads, writes): boolean masks over the scratch columns of a tile that
    a frame job's units read and write, taken together, as the kernel's
    epilogues address them (the `lsnr` column is counted as read whether or
    not gating is on)."""
    reads, writes = np.zeros(SCR, bool), np.zeros(SCR, bool)

    def rd(col, n):
        reads[col: col + n] = True

    def wr(col, n):
        writes[col: col + n] = True

    ty = int(job[J_TYPE])
    if ty == T_ADVANCE:
        rd(OFF["buf"] + HOP, HOP), wr(OFF["buf"], 2 * HOP)
        rd(OFF["fswin"] + 192, 384), wr(OFF["fswin"], 384)
        rd(OFF["erbwin"] + NB_ERB, 2 * NB_ERB), wr(OFF["erbwin"], 2 * NB_ERB)
        rd(OFF["silctr"], 1), wr(OFF["silctr"], 1), wr(OFF["mute"], 1)
        return reads, writes
    if ty == T_LSNR:
        rd(OFF["emb2"], 128), wr(OFF["lsnr"], 1)
        return reads, writes
    if ty != T_GEMM:
        raise ValueError(f"job type {ty} is no frame job")
    n = int(job[J_CW]) * int(job[J_SLICES])
    rd(int(job[J_XOFF]), int(job[J_K]))
    ep = int(job[J_EP])
    if ep == EP_STD:
        wr(int(job[J_Y]), n)
        if job[J_YRAW] >= 0:
            wr(int(job[J_YRAW]), n)
        if job[J_ADD] >= 0:
            rd(int(job[J_ADD]), n)
    elif ep == EP_SPEC:
        rd(OFF["unit"], NB_DF)
        wr(OFF["spec"], FPAD + n), wr(OFF["pow"], n), wr(OFF["unit"], NB_DF)
        wr(OFF["fswin"] + 384, 2 * NB_DF)
    elif ep == EP_ERBNORM:
        rd(OFF["mean"], n), wr(OFF["mean"], n), wr(OFF["erbwin"] + 2 * NB_ERB, n)
    elif ep == EP_GRU:
        rd(int(job[J_GH]), 2 * HID + n), rd(int(job[J_H]), n), wr(int(job[J_H]), n)
    elif ep == EP_TAIL:
        rd(OFF["spec"], FPAD + n), rd(OFF["c0"], CH * BLK), rd(OFF["coef"], ORDER * 2 * BLK)
        for ring in ("ring_re", "ring_im"):
            rd(OFF[ring], (ORDER - 1) * BLK), wr(OFF[ring], (ORDER - 1) * BLK)
        rd(OFF["lsnr"], 1), rd(OFF["mute"], 1)
        wr(OFF["se"], FPAD + n)
    elif ep == EP_OLA:
        rd(OFF["smem"], n), wr(OFF["smem"], n)
    return reads, writes


def edges(jobs: np.ndarray, frame_rows: List[int]) -> Dict[int, List[Tuple[int, int]]]:
    """For each frame job (its row in `jobs`), the jobs it waits for: (row of
    the producer, 0 for the same frame or -1 for the frame before). Two jobs
    conflict where one writes a column the other reads or writes; a job
    conflicts with itself a frame apart. Each conflict orders the later job
    of the frame order (`frame_rows`, phase by phase) after the earlier one
    of the same frame, and the earlier one after the later one of the frame
    before. Of those edges the plan keeps the ones that no path of others
    implies (the transitive reduction, over two frames; a path never goes
    back in time, so two frames hold every path an edge could be spared
    by). Every edge points backward in the global unit order."""
    pos = {r: i for i, r in enumerate(frame_rows)}
    acc = {r: job_access(jobs[r]) for r in frame_rows}
    full = {r: [] for r in frame_rows}
    for a in frame_rows:
        ra, wa = acc[a]
        for b in frame_rows:
            if pos[b] < pos[a]:
                continue
            rb, wb = acc[b]
            if not ((rb & wa).any() or (wb & ra).any() or (wb & wa).any()):
                continue
            if a != b:
                full[b].append((a, 0))
            full[a].append((b, -1))
    # forward edges of two unrolled frames: (row, frame) -> consumers
    succ: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for b, deps in full.items():
        for a, off in deps:
            for f in (0, 1):
                if 0 <= f + off:
                    succ.setdefault((a, f + off), []).append((b, f))

    def reaches(src, dst):
        seen, todo = set(), [src]
        while todo:
            node = todo.pop()
            for nxt in succ.get(node, ()):
                if (node, nxt) == (src, dst) or nxt in seen or nxt[1] > dst[1]:
                    continue
                if nxt == dst:
                    return True
                seen.add(nxt)
                todo.append(nxt)
        return False

    return {b: [(a, off) for a, off in deps if not reaches((a, 1 + off), (b, 1))]
            for b, deps in full.items()}


def unit_bytes(job: np.ndarray, bf16: bool) -> int:
    """What a unit of a frame job reads from L2: a product's input tile and
    its packed weight slice; an elementwise job's share of its columns."""
    if int(job[J_TYPE]) == T_ADVANCE:
        return (HOP + 2 * 192 + 2 * NB_ERB) * RT * 4 // int(job[J_AUX])
    if int(job[J_TYPE]) == T_LSNR:
        return 128 * RT * 4
    cols = packed_cols(int(job[J_NCAT]) * int(job[J_CW]), bf16)
    return int(job[J_K]) * (RT * 4 + cols * (2 if bf16 else 4))


def deal(jobs: np.ndarray, frame_phases: np.ndarray, n_blocks: int, bf16: bool) -> np.ndarray:
    """[frame phases, blocks]: the rank of each block in each frame phase;
    block b runs the phase's units u with u mod n_blocks = its rank. Phase by
    phase, the blocks that have read least from L2 so far in the frame
    (`unit_bytes`) take the first ranks, so that over a frame every block
    reads about as much; within a phase the units still spread over as many
    blocks as there are units."""
    load = np.zeros(n_blocks)
    ranks = np.empty((len(frame_phases), n_blocks), np.int64)
    for ph, (first, count, units) in enumerate(frame_phases):
        order = np.argsort(load, kind="stable")
        ranks[ph, order] = np.arange(n_blocks)
        cost = np.concatenate([np.full(int(j[J_UNITS]), unit_bytes(j, bf16))
                               for j in jobs[first: first + count]])
        np.add.at(load, order[np.arange(units) % n_blocks], cost)
    return ranks


def unit_order(table: np.ndarray, n_frames: int):
    """The global order of a launch's frame units, which every block walks
    its own units in: frame by frame, phase by phase, a phase's units by
    number (the plan deals them over the blocks, `deal`). Yields (frame, job
    row, tile, part) with part the column slice (products) or the chunk
    (elementwise jobs)."""
    t = decode(table)
    tiles, n_pre = int(t.header[H_TILES]), int(t.header[H_PRE])
    for f in range(n_frames):
        for first, count, units in t.phases[n_pre: n_pre + int(t.header[H_FRAME_PHASES])]:
            ji, j = int(first), t.jobs[int(first)]
            for u in range(int(units)):
                while u >= j[J_BEGIN] + j[J_UNITS]:
                    ji += 1
                    j = t.jobs[ji]
                local = u - int(j[J_BEGIN])
                yield f, ji, local % tiles, local // tiles


def plan(s: int, n_blocks: int, bf16: bool = False):
    """The plan for S streams on n_blocks persistent blocks (one per
    multiprocessor), for the float32 build or (`bf16`) the bfloat16 one.

    Returns (table, info): `table` the int32 array the kernel reads (header,
    scratch offsets, carry segments, phases, jobs, edges, the frame phases'
    block ranks as uint16 pairs), `info` a dict with
    `tiles`, `blocks`, `scratch_shape`, `n_stages`, `phases` (per phase a
    list of (job name, cw, kg, units)), `packing`, `pack_floats` for
    `pack_weights`, `bf16`, `names` (each job row's name), `edges` (each
    frame job's producers, see `edges`), `n_counters` (the uint32 words
    the kernel's counters take: the pre- and post-phases' grid barrier, then
    one per job and tile) and `ranks` (`deal`)."""
    from deepfilternet_torch.ops.whole_cell import WKEYS

    tiles = -(-s // RT)
    wid = {k: i for i, k in enumerate(WKEYS)}
    packing, pack_floats = [], 0
    frame = frame_phases()
    phases = PRE_PHASES + frame + [POST_PHASE]
    ph_rows, job_rows, info_ph, names = [], [], [], []
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
                        mc, j.rnd, j.kseg, 0, 0]
                pack_floats += units // tiles * j.k * packed_cols(cw * j.ncat, bf16)
                rows.append((j.name, cw, kg, units))
            else:
                units = j.chunks * tiles
                r[J_TYPE], r[J_BEGIN], r[J_UNITS], r[J_AUX] = j.type, begin, units, j.chunks
                rows.append((j.name, 0, 0, units))
            begin += units
            job_rows.append(r)
            names.append(j.name)
        ph_rows.append([first, len(jobs), begin])
        info_ph.append(rows)
    # the frame jobs' producers, one table row each, after the jobs
    n_pre = len(PRE_PHASES)
    jobs_np = np.asarray(job_rows, np.int64)
    frame_rows = list(range(ph_rows[n_pre][0], ph_rows[-1][0]))
    deps = edges(jobs_np, frame_rows)
    dep_rows = []
    for b in frame_rows:
        job_rows[b][J_DEP0], job_rows[b][J_NDEP] = len(dep_rows), len(deps[b])
        for a, off in deps[b]:
            dep_rows.append([a, job_rows[a][J_UNITS] // tiles, off])
    ranks = deal(np.asarray(job_rows, np.int64), np.asarray(ph_rows[n_pre: n_pre + len(frame)]),
                 n_blocks, bf16)
    packed_ranks = np.append(ranks.reshape(-1), [0] * (ranks.size % 2)).astype(np.uint16)
    lay = [OFF[n] for n, _ in LAYOUT]
    segs = [[CKEY_ORDER.index(k), a, n, o] for k, a, n, o in CARRY_SEGMENTS]
    header = [len(phases), len(job_rows), tiles, len(frame), n_pre, len(segs), len(lay), SCR,
              len(dep_rows)]
    table = np.asarray(header + lay + sum(segs, []) + sum(ph_rows, []) + sum(job_rows, [])
                       + sum(dep_rows, []) + packed_ranks.view(np.int32).tolist(), np.int32)
    info = dict(tiles=tiles, blocks=n_blocks, scratch_shape=(tiles, SCR, RT),
                n_stages=len(STAGES), phases=info_ph, packing=packing,
                pack_floats=pack_floats, bf16=bf16, names=names, edges=deps,
                n_counters=1 + len(job_rows) * tiles, ranks=ranks)
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
    deps: np.ndarray
    ranks: np.ndarray  # [frame phases, blocks]


def decode(table: np.ndarray) -> Table:
    h = table[:HEADER_INTS]
    a = HEADER_INTS
    lay = table[a: a + h[H_LAY]]
    a += h[H_LAY]
    segs = table[a: a + 4 * h[H_SEGS]].reshape(-1, 4)
    a += 4 * h[H_SEGS]
    phases = table[a: a + PHASE_INTS * h[H_PHASES]].reshape(-1, PHASE_INTS)
    a += PHASE_INTS * h[H_PHASES]
    jobs = table[a: a + JOB_INTS * h[H_JOBS]].reshape(-1, JOB_INTS)
    assert len(jobs) == h[H_JOBS]
    a += JOB_INTS * h[H_JOBS]
    deps = table[a: a + DEP_INTS * h[H_DEPS]].reshape(-1, DEP_INTS)
    a += DEP_INTS * h[H_DEPS]
    ranks = np.ascontiguousarray(table[a:]).view(np.uint16)  # one pad value where odd
    n_fp = int(h[H_FRAME_PHASES])
    ranks = ranks[: len(ranks) // n_fp * n_fp].reshape(n_fp, -1).astype(np.int64)
    return Table(h, lay, segs, phases, jobs, deps, ranks)


def job_deps(t: Table, ji: int) -> np.ndarray:
    """The edges of job row `ji`: rows of (producer job row, its units a
    tile in a frame, frame offset)."""
    first, n = int(t.jobs[ji][J_DEP0]), int(t.jobs[ji][J_NDEP])
    return t.deps[first: first + n]


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


def _cols(col: int, n: int) -> slice:
    return slice(col, col + n)


class _Scratch:
    """[S, SCR] scratch. Job by job (`record`), it records which columns
    each job reads and writes; unit by unit (`check`), which unit last wrote
    each value (`ver`, -1 before the frames), and reports a read that finds
    another version than the phase order leaves there (`expect`)."""

    def __init__(self, s: int, record: bool, check: bool):
        self.a = torch.zeros((s, SCR), dtype=torch.float32)
        self.record = record
        self.ver = torch.full((s, SCR), -1, dtype=torch.int64) if check else None
        self.reads: Dict[str, set] = {}
        self.writes: Dict[str, set] = {}
        self.job, self.frame = "", 0
        self.rows = slice(None)
        self.stamp = -1                              # the version the running unit writes
        self.expect = torch.full((SCR,), -1, dtype=torch.int64)  # the versions it should read
        self.bad: List[Tuple[str, int, int]] = []    # (job, frame, values read at a wrong version)

    def rd(self, col: int, n: int, mask=None) -> torch.Tensor:
        if self.record:
            self.reads.setdefault(self.job, set()).update(range(col, col + n))
        idx = _cols(col, n)
        if self.ver is not None:
            ver, want = self.ver[self.rows, idx], self.expect[idx]
            if not torch.equal(ver, want.expand_as(ver)):
                wrong = ver != want if mask is None else (ver != want) & mask
                if wrong.any():
                    self.bad.append((self.job, self.frame, int(wrong.sum())))
        return self.a[self.rows, idx]

    def wr(self, col: int, val: torch.Tensor, mask=None) -> None:
        idx = _cols(col, val.shape[1])
        if mask is not None:
            val = torch.where(mask, val, self.a[self.rows, idx])
        self.a[self.rows, idx] = val
        self.keep(col, val.shape[1], mask)

    def keep(self, col: int, n: int, mask=None) -> None:
        """Columns col .. col + n written, as far as the records go (the
        values stay)."""
        if self.record:
            self.writes.setdefault(self.job, set()).update(range(col, col + n))
        if self.ver is None:
            return
        ver = self.ver[self.rows, _cols(col, n)]
        if mask is None:
            ver[...] = self.stamp
        else:
            ver[mask] = self.stamp


def _act(v, act):
    return {ACT_NONE: lambda x: x, ACT_RELU: torch.relu, ACT_SIGMOID: torch.sigmoid,
            ACT_TANH: torch.tanh}[act](v)


def _expected_writers(t: Table, frame_rows: List[int]) -> np.ndarray:
    """[frame jobs, SCR]: for a reader at each position of the frame order,
    the position of the job whose write it must find in each column, in its
    own frame (0 ...) or, as that minus the frame jobs, the frame before;
    far below 0 where no frame job writes the column."""
    n = len(frame_rows)
    writes = np.stack([job_access(t.jobs[r])[1] for r in frame_rows])
    never = -(10 ** 9)
    last = np.where(writes.any(0), n - 1 - np.argmax(writes[::-1], 0), never)
    exp = np.empty((n, SCR), np.int64)
    exp[0] = np.where(last > never, last - n, never)
    for p in range(1, n):
        exp[p] = np.where(writes[p - 1], p - 1, exp[p - 1])
    return exp


def run_plan(table: np.ndarray, audio: torch.Tensor, carry: Dict[str, torch.Tensor],
             weights: Dict[str, torch.Tensor], statics, packed: torch.Tensor,
             hazards: Optional[list] = None, schedule=None, accesses: Optional[dict] = None):
    """Execute a plan table on the CPU, every product on its weight from the
    packed buffer (`pack_weights`), every epilogue as the kernel writes it,
    and with a bfloat16 buffer every rounding as the kernel rounds. Returns
    (new carry, enhanced audio) like `cell_process`.

    `schedule` None: every phase in order, every job whole (all its units at
    once). `hazards` collects (phase, job a, job b) for every pair of jobs of
    one phase where a reads or writes columns that b writes; `accesses`
    gathers {job row: (columns read, columns written)} over the run.

    Otherwise unit by unit (`unit_order`'s units: a tile's rows by a
    product's column slice, or an elementwise job's chunk), each waiting, as
    in the kernel, until every producer of its job (the table's edges) has
    counted its units in that tile up to the frame the edge names: "phase"
    runs them in the global order; an int seeds a random order among the
    units whose producers are done; (seed, job row) is that order with the
    job's units of the first frame put off while any other unit can run.
    Given `hazards`, every read is held to the version the phase order leaves
    there (the unit that wrote it last), and `hazards` collects (job, frame,
    values read at another version)."""
    from deepfilternet_torch.ops.whole_cell import WKEYS

    t = decode(table)
    L = {name: int(t.lay[i]) for i, (name, _) in enumerate(LAYOUT)}
    s, total = audio.shape
    n_frames = total // HOP
    tiles, n_pre = int(t.header[H_TILES]), int(t.header[H_PRE])
    n_fp = int(t.header[H_FRAME_PHASES])
    W = [weights[k].float() for k in WKEYS]
    wf = dict(zip(WKEYS, W))
    bf16 = packed.dtype == torch.bfloat16
    unpacked: Dict[int, torch.Tensor] = {}

    def rb(v):  # a result rounded to the operand type
        return v.to(torch.bfloat16).float() if bf16 else v

    sc = _Scratch(s, schedule is None, schedule is not None and hazards is not None)
    out = torch.zeros_like(audio)
    new_carry = {k: torch.zeros_like(v) for k, v in carry.items()}
    st = statics
    a = st.alpha

    def frame_in(f, shift, rows=slice(None), chunk=None, chunks=1):
        r = torch.arange(s)[rows] % RT  # row in its tile

        def mask(ncols, row_major):  # the values of element chunk `chunk`, as the kernel deals
            if chunk is None:
                return None
            c = torch.arange(ncols)[None]
            i = r[:, None] * ncols + c if row_major else c * RT + r[:, None]
            return (i // THREADS) % chunks == chunk

        m_buf = mask(HOP, True)
        if shift:
            sc.wr(L["buf"], sc.rd(L["buf"] + HOP, HOP, m_buf), m_buf)
            for name, n in (("fswin", 192), ("erbwin", NB_ERB)):
                m = mask(n, False)
                m = None if m is None else torch.cat([m, m], dim=1)
                sc.wr(L[name], sc.rd(L[name] + n, 2 * n, m).clone(), m)  # they overlap
        if f >= n_frames:  # past the last frame the counter and the flag stay
            if chunk in (None, 0):
                sc.keep(L["silctr"], 1)
                sc.keep(L["mute"], 1)
            return
        fr = audio[rows, f * HOP: (f + 1) * HOP]
        sc.wr(L["buf"] + HOP, fr, m_buf)
        if chunk in (None, 0):
            rms = torch.sqrt(torch.mean(fr * fr, dim=-1, keepdim=True))
            ctr = torch.where(rms < st.silence_thresh, sc.rd(L["silctr"], 1) + 1.0,
                              torch.zeros_like(rms))
            sc.wr(L["silctr"], ctr)
            sc.wr(L["mute"], (ctr >= st.silence_frames).to(torch.float32))

    def gemm(ji, f, rows, c0, m):
        """Product job `ji` for stream rows `rows` and the columns c0 ..
        c0 + m of each of its groups (all of them, or one unit's slice)."""
        j = t.jobs[ji]
        k, ncat = int(j[J_K]), int(j[J_NCAT])
        if ji not in unpacked:
            unpacked[ji] = unpack_weight(packed, j).float()
        w = unpacked[ji][:, :, c0: c0 + m]
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
            v = cats[0] if bias is None else trunk(cats[0] + bias[c0: c0 + m])
            v = _act(v, int(j[J_ACT]))
            if j[J_YRAW] >= 0:
                sc.wr(int(j[J_YRAW]) + c0, v)
            if j[J_ADD] >= 0:
                v = trunk(v + sc.rd(int(j[J_ADD]) + c0, m))
            sc.wr(int(j[J_Y]) + c0, v)
        elif ep == EP_SPEC:
            re, im = cats
            pw = re * re + im * im
            sc.wr(L["spec"] + c0, re)
            sc.wr(L["spec"] + FPAD + c0, im)
            sc.wr(L["pow"] + c0, pw)
            n_lo = min(c0 + m, NB_DF) - c0  # the unit norm's bins
            if n_lo > 0:
                un = torch.sqrt(pw[:, :n_lo]) * (1.0 - a) + sc.rd(L["unit"] + c0, n_lo) * a
                sc.wr(L["unit"] + c0, un)
                scale = torch.rsqrt(un)
                sc.wr(L["fswin"] + 384 + c0, re[:, :n_lo] * scale)
                sc.wr(L["fswin"] + 384 + NB_DF + c0, im[:, :n_lo] * scale)
        elif ep == EP_ERBNORM:
            db = 10.0 * torch.log10(cats[0] + 1e-10)
            mean = db * (1.0 - a) + sc.rd(L["mean"] + c0, m) * a
            sc.wr(L["mean"] + c0, mean)
            sc.wr(L["erbwin"] + 2 * NB_ERB + c0, (db - mean) / 40.0)
        elif ep == EP_GRU:
            gi = [trunk(cats[c] + bias[c * HID + c0: c * HID + c0 + m]) for c in range(3)]
            gh = [sc.rd(int(j[J_GH]) + c * HID + c0, m) for c in range(3)]
            h = sc.rd(int(j[J_H]) + c0, m)
            r = torch.sigmoid(gi[0] + gh[0])
            z = torch.sigmoid(gi[1] + gh[1])
            ng = torch.tanh(gi[2] + r * gh[2])
            sc.wr(int(j[J_H]) + c0, (1.0 - z) * ng + z * h)
        elif ep == EP_TAIL:
            g = cats[0]
            re, im = sc.rd(L["spec"] + c0, m), sc.rd(L["spec"] + FPAD + c0, m)
            m_re, m_im = re * g, im * g
            se_re, se_im = m_re.clone(), m_im.clone()
            n_lo = min(c0 + m, BLK) - c0
            if n_lo > 0:  # the DF MAC's lanes
                lo = slice(0, n_lo)
                df = (torch.arange(c0, c0 + n_lo) < NB_DF)[None]
                cur_re, cur_im = re[:, lo] * df, im[:, lo] * df

                def taps(name, n):
                    return torch.stack([sc.rd(L[name] + i * BLK + c0, n_lo) for i in range(n)],
                                       dim=1)

                conv = taps("c0", CH)
                ring_re, ring_im = taps("ring_re", ORDER - 1), taps("ring_im", ORDER - 1)
                coef = taps("coef", ORDER * 2)
                cp = torch.einsum("co,scf->sof", wf["convp_co"], conv)
                cb = wf["convp_b"][0]
                y_re = torch.zeros_like(cur_re)
                y_im = torch.zeros_like(cur_im)
                for n_ in range(ORDER):
                    t_re = ring_re[:, n_] if n_ < ORDER - 1 else cur_re
                    t_im = ring_im[:, n_] if n_ < ORDER - 1 else cur_im
                    c_re = coef[:, 2 * n_] + torch.relu(cp[:, 2 * n_] + cb[2 * n_])
                    c_im = coef[:, 2 * n_ + 1] + torch.relu(cp[:, 2 * n_ + 1] + cb[2 * n_ + 1])
                    y_re = y_re + t_re * c_re - t_im * c_im
                    y_im = y_im + t_re * c_im + t_im * c_re
                for name, ring, cur in (("ring_re", ring_re, cur_re), ("ring_im", ring_im, cur_im)):
                    for i in range(ORDER - 1):
                        sc.wr(L[name] + i * BLK + c0, ring[:, i + 1] if i < ORDER - 2 else cur)
                se_re[:, lo] = torch.where(df, y_re, m_re[:, lo])
                se_im[:, lo] = torch.where(df, y_im, m_im[:, lo])
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
            imult = wf["imult"].reshape(-1)[c0: c0 + m]
            sc.wr(L["se"] + c0, se_re * imult)
            sc.wr(L["se"] + FPAD + c0, se_im * imult)
        elif ep == EP_OLA:
            out[rows, f * HOP + c0: f * HOP + c0 + m] = cats[0] + sc.rd(L["smem"] + c0, m)
            sc.wr(L["smem"] + c0, cats[1])

    def lsnr():
        e = rb(sc.rd(L["emb2"], 128))
        ls = torch.sigmoid(e @ wf["lsnr_w"] + wf["lsnr_b"])
        sc.wr(L["lsnr"], ls * (st.lsnr_max - st.lsnr_min) + st.lsnr_min)

    def whole_job(ji, f):
        j = t.jobs[ji]
        ty = int(j[J_TYPE])
        if ty == T_GEMM:
            gemm(ji, f, slice(None), 0, int(j[J_CW]) * int(j[J_SLICES]))
        elif ty == T_CARRY_IN:
            for key, cs, n, so in t.segs:
                sc.wr(int(so), carry[CKEY_ORDER[key]][:, cs: cs + n])
        elif ty == T_FRAME0:
            frame_in(0, False)
        elif ty == T_ADVANCE:
            frame_in(f + 1, True)
        elif ty == T_LSNR:
            lsnr()
        elif ty == T_CARRY_OUT:
            for key, cs, n, so in t.segs:
                new_carry[CKEY_ORDER[key]][:, cs: cs + n] = sc.rd(int(so), int(n))
            new_carry["sil"][:, 1:] = carry["sil"][:, 1:]

    def run_phase(pi, f):
        first, count = int(t.phases[pi][0]), int(t.phases[pi][1])
        sc.frame = f
        sc.reads.clear()
        sc.writes.clear()
        for ji in range(first, first + count):
            sc.job = f"job {ji}"
            whole_job(ji, f)
        if accesses is not None:
            for ji in range(first, first + count):
                r, w = accesses.setdefault(ji, (set(), set()))
                r |= sc.reads.get(f"job {ji}", set())
                w |= sc.writes.get(f"job {ji}", set())
        if hazards is not None:
            names = list(sc.writes)
            for b in names:
                for other in set(sc.reads) | set(sc.writes):
                    if other == b:
                        continue
                    touched = sc.reads.get(other, set()) | sc.writes.get(other, set())
                    if touched & sc.writes[b]:
                        hazards.append((pi, other, b))

    for pi in range(n_pre):
        run_phase(pi, 0)
    if schedule is None:
        for f in range(n_frames):
            for pi in range(n_fp):
                run_phase(n_pre + pi, f)
        run_phase(n_pre + n_fp, 0)
        return new_carry, out

    frame_rows = list(range(int(t.phases[n_pre][0]), int(t.phases[n_pre + n_fp][0])))
    pos = {r: i for i, r in enumerate(frame_rows)}
    expect = torch.from_numpy(_expected_writers(t, frame_rows))
    n_pos = len(frame_rows)
    expected: Dict[Tuple[int, int], torch.Tensor] = {}

    def run_unit(f, ji, tile, part):
        j = t.jobs[ji]
        rows = slice(tile * RT, min(s, (tile + 1) * RT))
        sc.job, sc.frame, sc.rows = f"job {ji}", f, rows
        sc.stamp = f * n_pos + pos[ji]
        if (f, ji) not in expected:
            expected[(f, ji)] = torch.clamp(f * n_pos + expect[pos[ji]], min=-1)
        sc.expect = expected[(f, ji)]
        ty = int(j[J_TYPE])
        if ty == T_GEMM:
            cw = int(j[J_CW])
            gemm(ji, f, rows, part * cw, cw)
        elif ty == T_ADVANCE:
            frame_in(f + 1, True, rows, part, int(j[J_AUX]))
        elif ty == T_LSNR:
            lsnr()
        else:
            raise ValueError(f"job type {ty} in a frame phase")

    order = list(unit_order(table, n_frames))
    if schedule == "phase":
        for unit in order:
            run_unit(*unit)
    else:
        seed, defer = schedule if isinstance(schedule, tuple) else (schedule, None)
        rng = np.random.default_rng(seed)
        parts: Dict[Tuple[int, int, int], List[int]] = {}
        for f, ji, tile, part in order:
            parts.setdefault((f, ji, tile), []).append(part)
        per_tile = [int(j[J_UNITS]) // tiles for j in t.jobs]
        done = np.zeros((len(t.jobs), tiles), np.int64)  # the kernel's counters
        waiting, free, put_off = list(parts), [], []

        def release():
            nonlocal waiting
            still = []
            for key in waiting:
                f, ji, tile = key
                if all(done[d[D_JOB], tile] >= d[D_PER_TILE] * (f + 1 + d[D_FRAME])
                       for d in job_deps(t, ji)):
                    (put_off if (ji, f) == (defer, 0) else free).extend(
                        (key, p) for p in parts[key])
                else:
                    still.append(key)
            waiting = still

        release()
        while free or put_off:
            pool = free if free else put_off
            i = int(rng.integers(len(pool)))
            pool[i], pool[-1] = pool[-1], pool[i]
            (f, ji, tile), part = pool.pop()
            run_unit(f, ji, tile, part)
            done[ji, tile] += 1
            if done[ji, tile] % per_tile[ji] == 0:
                release()
        if waiting:
            raise RuntimeError(f"the plan's edges never release {len(waiting)} job tiles")
    sc.job, sc.frame, sc.rows = "carry out", n_frames, slice(None)
    sc.expect = torch.clamp(n_frames * n_pos + expect[0], min=-1)
    whole_job(int(t.phases[n_pre + n_fp][0]), 0)
    if hazards is not None:
        hazards.extend(sc.bad)
    return new_carry, out
