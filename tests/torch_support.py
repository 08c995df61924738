"""Shared fixture of the port's CPU tests (tests/test_torch_*.py)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread while a port test module runs. The plain
    versions of the kernels are loops of many tiny tensor ops, and the test
    suite runs several worker processes side by side: with a pool of one
    thread per core in every worker, those loops measured over ten times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(cfg):
    """The port's CodecConfig with the fields of the reference's `cfg`."""
    from screenpressor_tpu_torch.config import CodecConfig

    return CodecConfig(**dataclasses.asdict(cfg))


# One-byte flips (payload, byte, xor) of the default stream of
# corrupt_payloads whose indices the port once took past their tensors
# (IndexError, a device-side assert on the card) before the error word
# decided: two make the bt runs hold at least two more blocks than the
# header counts (a slot index past the sink slot), two give a sub-rect with
# x1 > x2 and y1 > y2 (grid positions past the block).
INDEX_SITE_FLIPS = ((2, 2, 4), (2, 3, 15), (2, 19, 170), (2, 22, 87))
# the same two kinds, (byte, xor) of stream 1's frame 2 in the serving
# tests' steps (corrupt_payloads(seed=8, k_fixed=8) through BatchedEncoder)
SERVING_SITE_FLIPS = ((2, 4), (34, 2))


def flip(data: bytes, pos: int, x: int) -> bytes:
    p = bytearray(data)
    p[pos] ^= x
    return bytes(p)


def corrupt_payloads(n_flips=40, n_cuts=10, seed=6, device="cpu", k_fixed=None):
    """A 6-frame 48x64 synth_screencast stream encoded by the port, and
    damaged copies of its frames that carry sections: n_flips one-byte
    corruptions and n_cuts truncations, from a seed, then the
    INDEX_SITE_FLIPS. Returns (cfg, frames, payloads, [(frame index,
    damaged payload)])."""
    from screenpressor_tpu_torch import TorchEncoder
    from screenpressor_tpu_torch.config import CodecConfig
    from screenpressor_tpu_torch.synth import synth_screencast

    frames = synth_screencast(48, 64, 6)
    cfg = CodecConfig(width=64, height=48, k_fixed=k_fixed)
    payloads = [p for p, _ in TorchEncoder(cfg, device).encode_batch(frames)]
    coded = [i for i, p in enumerate(payloads) if len(p) > 8]
    rng = np.random.default_rng(seed)
    damaged = []
    for c in range(n_flips + n_cuts):
        i = coded[int(rng.integers(len(coded)))]
        if c < n_flips:
            p = payloads[i]
            data = flip(p, int(rng.integers(len(p))), int(rng.integers(1, 256)))
        else:
            data = payloads[i][:int(rng.integers(1, len(payloads[i])))]
        damaged.append((i, data))
    damaged += [(i, flip(payloads[i], pos, x)) for i, pos, x in INDEX_SITE_FLIPS]
    return cfg, frames, payloads, damaged


def damaged_serving_steps(device="cpu"):
    """Steps of 4 streams at 48x64 from the port's BatchedEncoder: stream 1
    carries the frames of corrupt_payloads(seed=8, k_fixed=8), whose
    payloads it equals, the others different content (shifted and flipped
    copies), so that a write into another stream's frame shows. Returns
    (cfg, steps [t][stream] payloads, stream 1's payloads, damaged cases
    [(step, damaged stream-1 payload)]: the 40 flips of corrupt_payloads,
    then the SERVING_SITE_FLIPS)."""
    from screenpressor_tpu_torch.parallel.serving import BatchedEncoder

    cfg, frames, payloads, damaged = corrupt_payloads(seed=8, k_fixed=8, device=device)
    f = np.asarray(frames)
    streams = [np.roll(f, 3, axis=2), f, np.roll(f, 21, axis=2)[:, ::-1], f[:, :, ::-1]]
    enc = BatchedEncoder(len(streams), cfg, device)
    steps = [[p for p, _ in enc.encode(np.stack([s[t] for s in streams]))]
             for t in range(len(f))]
    assert [step[1] for step in steps] == payloads
    cases = damaged[:40] + [(2, flip(payloads[2], pos, x)) for pos, x in SERVING_SITE_FLIPS]
    return cfg, steps, payloads, cases


def rebuild_p_loop(recs, rows, prev, cfg):
    """pframe.rebuild_p stream by stream on the inputs of one
    rebuild_p_streams call (rows: its header rows on the host) -> (frames
    [C, H, W, 3], err [C])."""
    from screenpressor_tpu_torch import pframe

    frames, errs = [], []
    for j, row in enumerate(rows):
        ns = {name: int(n) for name, n in zip(pframe.SECTION_NAMES, row[:5])}
        one = {name: recs[name][j, :max(ns[name], 1)] for name in pframe.SECTION_NAMES}
        frame, err = pframe.rebuild_p(one, ns, *(int(v) for v in row[5:]), prev[j], cfg)
        frames.append(frame)
        errs.append(err)
    return torch.stack(frames), torch.stack(errs)


def record_index_sites(monkeypatch) -> set:
    """Watch the P decode's index sites that a corrupt stream can push out
    of range: the returned set gains "slots" when a block's slot index
    reaches its stream's cap (pframe._to_slots) and "grid" when a data
    block's sub-rect would put a position past the 17 x 16 grid without the
    clamp (pframe.reconstruct_blocks_streams)."""
    from screenpressor_tpu_torch import pframe

    hits = set()
    to_slots, rebuild = pframe._to_slots, pframe.reconstruct_blocks_streams

    def slots(mask, idx, vals, cap, *rest):
        if bool((mask & (idx > cap)).any()):
            hits.add("slots")
        return to_slots(mask, idx, vals, cap, *rest)

    def blocks(out, prev, rects, *rest):
        bw = (rects[:, 2] - rects[:, 0]).long()[:, None]
        bh = (rects[:, 3] - rects[:, 1]).long()[:, None]
        p = torch.arange(pframe.AREA)[None, :]
        ry = torch.where(p < bw * bh, p // bw.clamp_min(1), pframe.BLOCK)
        if bool(((ry > pframe.BLOCK) | (p % bw.clamp_min(1) >= pframe.BLOCK)).any()):
            hits.add("grid")
        return rebuild(out, prev, rects, *rest)

    monkeypatch.setattr(pframe, "_to_slots", slots)
    monkeypatch.setattr(pframe, "reconstruct_blocks_streams", blocks)
    return hits


def sp_encode(frames, mesh, cfg):
    """A lossless session through the port's encode_i_sp / encode_p_sp with
    chained tables: frame 0 a keyframe, then P frames against the frame
    before. Returns [(bytes, ftype)]."""
    from screenpressor_tpu_torch.parallel import mesh as tm

    out, tabs = [], None
    for i, f in enumerate(frames):
        if i == 0:
            data, ftype, tabs = tm.encode_i_sp(f, mesh, cfg)
        else:
            data, ftype, tabs = tm.encode_p_sp(f, frames[i - 1], mesh, cfg, tabs)
        out.append((data, ftype))
    return out


def sp_decode(payloads, mesh, cfg):
    """The frames of an sp_encode session through decode_i_sp /
    decode_p_sp, tables chained."""
    from screenpressor_tpu_torch.parallel import mesh as tm

    frame, tabs = tm.decode_i_sp(payloads[0][0], mesh, cfg)
    out = [frame]
    for data, _ in payloads[1:]:
        frame, tabs = tm.decode_p_sp(data, frame, mesh, cfg, tabs)
        out.append(frame)
    return out


def sp_stage_ms(fn):
    """(fn(), {stage: ms}): stage_ms over the stages that
    screenpressor_tpu_torch.parallel.mesh records as program spans
    ("sptc.sp.<stage>")."""
    return stage_ms(fn, "sptc.sp.")


def stage_ms(fn, prefix):
    """(fn(), {stage: ms}): fn run under torch.profiler; for each stage, a
    record_function range or a program span (`telemetry.span`) named
    `prefix + stage`, the device time of the kernels and copies launched
    while it was open on the host, summed over its calls. A device event
    belongs to the host launch call (cudaLaunchKernel, cudaMemcpyAsync,
    ...) with its correlation id; the launch's host time places it in a
    range (program spans keep the clock of the profiler's host events).
    The kernels of ctypes launches are joined to no PyTorch op, so the
    ranges' own device totals miss them. Without a CUDA device the times
    are 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from screenpressor_tpu_torch import telemetry

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    first = len(telemetry.spans())
    with profile(activities=acts) as prof:
        out = fn()
        for i in range(torch.cuda.device_count() if cuda else 0):
            torch.cuda.synchronize(i)
    events = list(prof.profiler.kineto_results.events())
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    ranges = [(e.start_ns(), e.end_ns(), e.name()[len(prefix):]) for e in cpu
              if e.name().startswith(prefix)]
    ranges += [(s.start_ns, s.end_ns, s.name[len(prefix):]) for s in telemetry.spans()[first:]
               if s.name.startswith(prefix)]
    launched = {e.correlation_id(): e.start_ns() for e in cpu if e.name().startswith("cu")}
    ms = {name: 0.0 for _, _, name in ranges}
    for e in events:
        at = launched.get(e.correlation_id())
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() or at is None:
            continue
        for lo, hi, name in ranges:
            if lo <= at <= hi:
                ms[name] += e.duration_ns() / 1e6
    return out, ms


# The motion search fixtures' config (msr 8, low 2: 46 candidates) and
# frame size (block rows and columns 16, 16, 8 / 16, 16, 16, 8 pixels).
MS_CFG = dict(width=56, height=40, msr_x=8, msr_y=8, msr_low_x=2, msr_low_y=2)


def _ms_noise(rng, c, h=40, w=56):
    return rng.integers(0, 256, (c, h, w, 3), dtype=np.uint8)


def _ms_desktop(rng, h, w):
    """A flat background with short strokes of a few colours (text-like)."""
    img = np.full((h, w, 3), (40, 44, 52), np.uint8)
    pal = rng.integers(0, 256, (4, 3))
    for _ in range(h * w // 40):
        y, x = int(rng.integers(h)), int(rng.integers(w - 6))
        img[y, x:x + int(rng.integers(1, 6))] = pal[int(rng.integers(4))]
    return img


def _ms_shift(cur, prev, box, mx, my):
    """cur's box (x1, y1, x2, y2) := prev shifted by (mx, my): a block whose
    sub-rect matches at that candidate (and, prev being noise, at no
    other)."""
    x1, y1, x2, y2 = box
    cur[y1:y2, x1:x2] = prev[y1 + my:y2 + my, x1 + mx:x2 + mx]


def _ms_clamp_shift(cur, prev, box, mx, my):
    """cur's box := prev shifted by (mx, my) with coordinates clamped into
    the frame: what a search that clamps its reads without the exact bounds
    test would take as a match of (mx, my)."""
    h, w = prev.shape[:2]
    x1, y1, x2, y2 = box
    ys = np.clip(np.arange(y1, y2) + my, 0, h - 1)
    xs = np.clip(np.arange(x1, x2) + mx, 0, w - 1)
    cur[y1:y2, x1:x2] = prev[ys[:, None], xs[None, :]]


def _ms_flat_shift(cur, prevs, s, box, d):
    """Stream s's box := its prev read at flat pixel offset +d over the
    whole [C, H, W] call (rows wrap, the frame's end runs into the next
    stream's): what a search without the exact bounds test would take as a
    match of the candidate whose offset is d."""
    c, h, w, _ = prevs.shape
    flat = prevs.reshape(-1, 3)
    x1, y1, x2, y2 = box
    for y in range(y1, y2):
        for x in range(x1, x2):
            cur[y, x] = flat[(s * h + y) * w + x + d]


def motion_search_fixtures(seed=70):
    """The motion search's fixtures at MS_CFG: name -> (frames, prevs [C,
    40, 56, 3] uint8, expect {(stream, block): (mx, my) or None}, the
    choices the fixture was built to give, None meaning no match).

    noise: two noise frames against noise prevs, every block changed and
      none matching;
    last: the only match of a full and of a partial block is the last
      candidate, (2, 2);
    edges: sub-rects that a candidate puts exactly at the frame's edge
      (x2 + mx == W, y2 + my == H, x1 + mx == 0, y1 + my == 0: found) and
      one past it (taken as a match only by a search that reads flat
      offsets across rows or into the neighbouring stream, or that clamps
      its reads into the frame: no match);
    streams: four streams with different change maps in one call (noise,
      idle, a desktop scrolled by 3 rows with a window moved on it, a
      typed block);
    idle: no changed block;
    flat: three flat frames: against a noise prev whose left 20 columns
      are the flat colour, against their own copy, and with one pixel of
      the last (partial) block changed."""
    from screenpressor_tpu_torch.blocks import mv_candidates
    from screenpressor_tpu_torch.config import CodecConfig

    h, w = MS_CFG["height"], MS_CFG["width"]
    nbx = -(-w // 16)
    cands = mv_candidates(CodecConfig(**MS_CFG))
    rng = np.random.default_rng(seed)

    def blk(x, y):
        return (y // 16) * nbx + x // 16

    out = {}
    prevs = _ms_noise(rng, 2)
    out["noise"] = (_ms_noise(rng, 2), prevs, {(s, b): None for s in range(2)
                                               for b in range(3 * nbx)})

    prevs = _ms_noise(rng, 1)
    cur = prevs.copy()
    last = cands[-1]
    for box in ((18, 17, 30, 30), (49, 33, 54, 38)):  # a full block's box, a partial one's
        _ms_shift(cur[0], prevs[0], box, *last)
    out["last"] = (cur, prevs, {(0, blk(18, 17)): last, (0, blk(49, 33)): last})

    prevs = _ms_noise(rng, 2)
    cur = prevs.copy()
    expect = {}
    for s, box, mv in ((0, (49, 3, 55, 9), (1, 0)),      # x2 + mx == W
                       (0, (18, 33, 26, 39), (0, 1)),    # y2 + my == H
                       (0, (1, 20, 7, 28), (-1, 0)),     # x1 + mx == 0
                       (0, (20, 1, 27, 7), (0, -1))):    # y1 + my == 0
        _ms_shift(cur[s], prevs[s], box, *mv)
        expect[(s, blk(box[0], box[1]))] = mv
    for s, box, d in ((0, (50, 19, 56, 25), 1),        # x2 + 1 == W + 1: wraps a row
                      (0, (36, 34, 44, 40), w),        # y2 + 1 == H + 1: stream 1's row 0
                      (1, (35, 0, 42, 6), -w),         # y1 - 1 == -1: stream 0's last row
                      (1, (0, 3, 6, 9), -1)):          # x1 - 1 == -1: wraps a row
        _ms_flat_shift(cur[s], prevs, s, box, d)
        expect[(s, blk(box[0], box[1]))] = None
    for s, box, mv in ((0, (49, 33, 55, 39), (2, 0)),     # x2 + 2 == W + 1
                       (1, (20, 33, 28, 39), (0, 2)),     # y2 + 2 == H + 1
                       (1, (1, 18, 7, 26), (-2, 0)),      # x1 - 2 == -1
                       (1, (49, 1, 55, 7), (0, -2))):     # y1 - 2 == -1
        _ms_clamp_shift(cur[s], prevs[s], box, *mv)
        expect[(s, blk(box[0], box[1]))] = None
    out["edges"] = (cur, prevs, expect)

    tall = _ms_desktop(rng, h + 8, w)
    desk = _ms_desktop(rng, h, w)
    typed = desk.copy()
    typed[21:27, 30:35] = (200, 30, 30)
    moved = tall[3:3 + h].copy()  # a scroll by 3 rows: candidate (0, 3)
    _ms_shift(moved, tall[:h], (16, 16, 32, 32), -2, 1)  # a window moved (-2, 1) on it
    prevs = np.stack([_ms_noise(rng, 1)[0], desk, tall[:h], desk])
    cur = np.stack([_ms_noise(rng, 1)[0], desk, moved, typed])
    out["streams"] = (cur, prevs, {(0, b): None for b in range(3 * nbx)})

    prevs = np.stack([desk, tall[:h]])
    out["idle"] = (prevs.copy(), prevs, {})

    flat = np.full((3, h, w, 3), (17, 99, 230), np.uint8)
    prevs = flat.copy()
    prevs[0] = _ms_noise(rng, 1)[0]
    prevs[0, :, :20] = flat[0, :, :20]
    cur = flat.copy()
    cur[2, h - 1, w - 1] = (17, 99, 231)  # the last (partial) block, not flat
    out["flat"] = (cur, prevs, {})
    return out


# ---------------------------------------------------------------------------
# The P decode's data-block rebuild (pframe.reconstruct_blocks_streams, K6)
# ---------------------------------------------------------------------------

def _rb_records(rng, area, weights=None, max_run=12):
    """Runs of random predictor types covering `area` sequence positions, as
    decode_p_resolve_streams' to_grid lays them out: (ptypes [256], rlens
    [256], lits [256, 3]) int32, a literal's value only on literal
    records."""
    pt = np.zeros(256, np.int32)
    rl = np.zeros(256, np.int32)
    lt = np.zeros((256, 3), np.int32)
    i = pos = 0
    while pos < area:
        n = min(int(rng.integers(1, max_run + 1)), area - pos)
        pt[i], rl[i] = int(rng.choice(6, p=weights)), n
        if pt[i] == 0:
            lt[i] = rng.integers(0, 256, 3)
        i, pos = i + 1, pos + n
    return pt, rl, lt


def rebuild_fixtures(seed=90):
    """The block rebuild's fixtures: name -> (base, prev [C, h, w, 3] uint8,
    rects [B, 4] int32, bsid [B] int64, ptypes, rlens [B, 256] int32, lits
    [B, 256, 3] int32, ref_streams): numpy arrays. base stands for the
    motion-applied frames (the rebuild's output before it writes), prev
    for the true previous frames; ref_streams lists the streams whose
    pixels the reference (jx/pframe.py reconstruct_blocks) defines as the
    port does (all but a stream with a rect wider than a block or past
    the frame, whose error word decides its verdict).

    types: full blocks and a partial one, every predictor type;
    wrap: gradient chains over a prev of 0s and 255s (the int32 rows leave
      0..255; only their low byte reaches the frame);
    edges: sub-rects at the frame's top and left edges (the apron reads 0);
    partial: a 37 x 53 frame, sub-rects in the partial blocks at the right
      and bottom edges;
    motion: base differs from prev in the blocks left of, above and
      above-left of a data block that reads its neighbours (they must come
      from prev);
    empty: slots with x2 <= x1 or y2 <= y1 among real ones;
    streams: three streams in one call, slots interleaved;
    damaged: stream 0 with runs that overrun the block, zero-length runs
      and an inverted rect; stream 1 with a rect wider than a block and one
      that starts above and left of the frame."""
    rng = np.random.default_rng(seed)
    out = {}

    def make(name, c, h, w, slots, base=None, prev=None, ref_streams=None):
        prev = rng.integers(0, 256, (c, h, w, 3), dtype=np.uint8) if prev is None else prev
        base = rng.integers(0, 256, (c, h, w, 3), dtype=np.uint8) if base is None else base
        recs = [r for _, _, r in slots]
        out[name] = (base, prev, np.asarray([r for _, r, _ in slots], np.int32).reshape(-1, 4),
                     np.asarray([s for s, _, _ in slots], np.int64),
                     np.stack([r[0] for r in recs]), np.stack([r[1] for r in recs]),
                     np.stack([r[2] for r in recs]),
                     list(range(c)) if ref_streams is None else ref_streams)

    def area(rect):
        return max(rect[2] - rect[0], 0) * max(rect[3] - rect[1], 0)

    def slot(s, rect, **kw):
        return (s, rect, _rb_records(rng, area(rect), **kw))

    make("types", 1, 40, 56, [slot(0, r) for r in ((16, 16, 32, 32), (32, 0, 48, 16),
                                                   (0, 16, 16, 32), (20, 3, 29, 14))])
    grad = [0.05, 0.05, 0.05, 0.05, 0.75, 0.05]
    prev = (rng.integers(0, 2, (1, 40, 56, 3)) * 255).astype(np.uint8)
    make("wrap", 1, 40, 56, [slot(0, r, weights=grad, max_run=16)
                             for r in ((16, 16, 32, 32), (0, 0, 16, 16), (35, 18, 47, 29))],
         prev=prev)
    make("edges", 1, 40, 56, [slot(0, r) for r in ((0, 0, 16, 16), (16, 0, 25, 7),
                                                   (0, 16, 6, 30), (32, 0, 48, 1))])
    make("partial", 1, 37, 53, [slot(0, r) for r in ((48, 0, 53, 16), (0, 32, 16, 37),
                                                     (48, 32, 53, 37), (33, 33, 35, 36),
                                                     (50, 17, 52, 31))])
    prev = rng.integers(0, 256, (1, 40, 56, 3), dtype=np.uint8)
    base = prev.copy()
    base[0, 0:32, 0:16] = prev[0, 2:34, 1:17]    # motion blocks left and above-left
    base[0, 0:16, 16:32] = prev[0, 3:19, 18:34]  # the motion block above
    near = [0.1, 0.2, 0.2, 0.1, 0.2, 0.2]
    make("motion", 1, 40, 56, [slot(0, (16, 16, 32, 32), weights=near),
                               slot(0, (32, 16, 40, 30), weights=near)], base=base, prev=prev)
    make("empty", 1, 40, 56, [slot(0, (0, 0, 0, 0)), slot(0, (16, 0, 32, 16)),
                              slot(0, (16, 16, 16, 32)), slot(0, (5, 5, 3, 9)),
                              slot(0, (33, 20, 40, 20)), slot(0, (0, 16, 9, 27)),
                              slot(0, (0, 0, 0, 0))])
    make("streams", 3, 40, 56, [slot(1, (0, 0, 16, 16)), slot(0, (16, 16, 32, 32)),
                                slot(2, (48, 32, 56, 40)), slot(1, (32, 16, 41, 23)),
                                slot(0, (0, 0, 0, 0)), slot(2, (0, 32, 16, 40)),
                                slot(0, (48, 0, 56, 16))])
    over = _rb_records(rng, 256)
    over[1][:3] = (200, 100, 90)  # starts 0, 200, 300: the third is past the block
    zero = _rb_records(rng, 200, max_run=4)
    zero[1][[2, 5, 6]] = 0  # records that mark no position
    make("damaged", 2, 40, 56, [(0, (16, 16, 32, 32), over), (0, (0, 16, 16, 29), zero),
                                slot(0, (40, 20, 35, 18)), slot(0, (32, 0, 48, 16)),
                                slot(1, (20, 16, 44, 32)), slot(1, (-5, -3, 8, 10)),
                                slot(1, (40, 0, 56, 12))], ref_streams=[0])
    return out


@contextlib.contextmanager
def rebuild_calls(store):
    """While the block runs, append to `store` the inputs of each
    pframe.reconstruct_blocks_streams call (out, prev, rects, bsid, ptypes,
    rlens, lits), out cloned before the call writes it."""
    from screenpressor_tpu_torch import pframe

    real = pframe.reconstruct_blocks_streams

    def spy(out, *args):
        store.append((out.clone(), *args))
        return real(out, *args)

    pframe.reconstruct_blocks_streams = spy
    try:
        yield store
    finally:
        pframe.reconstruct_blocks_streams = real


def rebuild_single_writer(prev, rects, bsid):
    """[C * h * w] bool: the pixels of the frames prev [C, h, w, 3] that at
    most one slot of a rebuild call writes (each slot's rect clamped as the
    rebuild clamps it, inside its own stream's frame). Where two slots
    overlap (a damaged stream) the plain version's scatter picks no order;
    everywhere else it is deterministic."""
    c, h, w, _ = prev.shape
    dev = prev.device
    ar = torch.arange(16, device=dev)
    x1, y1 = rects[:, 0].long(), rects[:, 1].long()
    bw = (rects[:, 2] - rects[:, 0]).long().clamp(0, 16)
    bh = (rects[:, 3] - rects[:, 1]).long().clamp(0, 16)
    ys = y1[:, None, None] + ar[None, :, None]
    xs = x1[:, None, None] + ar[None, None, :]
    inside = ((ar[None, :, None] < bh[:, None, None]) & (ar[None, None, :] < bw[:, None, None])
              & (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w))
    idx = torch.where(inside, bsid.long()[:, None, None] * h * w + ys * w + xs, c * h * w)
    hits = torch.zeros(c * h * w + 1, dtype=torch.int32, device=dev)
    hits.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.int32, device=dev))
    return hits[:-1] <= 1


# ---------------------------------------------------------------------------
# The P decode's block resolution (pframe.decode_p_resolve_streams, K8)
# ---------------------------------------------------------------------------

SECTION_WIDTHS = {"bt": 2, "sxy": 4, "mv": 2, "rec": 2, "col": 3}


def _block_rect(i, nbx, h, w):
    x_lo, y_lo = 16 * (i % nbx), 16 * (i // nbx)
    return x_lo, y_lo, min(x_lo + 16, w), min(y_lo + 16, h)


def _records(rng, area, max_run):
    """Runs of random ptypes covering `area` positions -> (records [n, 2],
    literals [k, 3]) int32, a literal for each PT_LITERAL record."""
    if area <= 0:
        return np.zeros((0, 2), np.int32), np.zeros((0, 3), np.int32)
    rl = rng.integers(1, max_run + 1, area)
    n = int(np.searchsorted(np.cumsum(rl), area)) + 1
    rl = rl[:n]
    rl[-1] -= int(rl.sum()) - area
    pt = rng.integers(0, 6, n)
    lits = rng.integers(0, 256, (int((pt == 0).sum()), 3))
    return np.stack([pt, rl], 1).astype(np.int32), lits.astype(np.int32)


def random_blocks(rng, h, w, p_types=(0.5, 0.15, 0.1, 0.15, 0.1), max_run=12):
    """A clean P frame's changed blocks as the encoder codes them: {block
    index: (bt type, sub-rect (4,) or None, mv (2,) or None, records [n, 2],
    literals [k, 3])}; block types drawn with p_types (unchanged, full data,
    partial data, full motion, partial motion), sub-rects inside their
    block, motion vectors inside the frame, runs of at most max_run."""
    nbx, nby = -(-w // 16), -(-h // 16)
    blocks = {}
    for i in range(nbx * nby):
        t = int(rng.choice(5, p=p_types))
        if t == 0:
            continue
        x_lo, y_lo, x2, y2 = _block_rect(i, nbx, h, w)
        x1, y1, s = x_lo, y_lo, None
        if t in (2, 4):
            a, b = sorted(int(v) for v in rng.integers(0, x2 - x_lo, 2))
            c, d = sorted(int(v) for v in rng.integers(0, y2 - y_lo, 2))
            s = (a, c, b, d)
            x1, y1, x2, y2 = x_lo + a, y_lo + c, x_lo + b + 1, y_lo + d + 1
        m = None
        if t in (3, 4):
            m = (int(rng.integers(-x1, w - x2 + 1)), int(rng.integers(-y1, h - y2 + 1)))
        area = (x2 - x1) * (y2 - y1) if t in (1, 2) else 0
        blocks[i] = (t, s, m, *_records(rng, area, max_run))
    return blocks


def stream_sections(blocks, nb, full_range=False):
    """One stream's section records and header row from its blocks (as
    random_blocks gives them) -> ({name: [n, W] int32}, header row as
    pframe.header_row). The BT runs (at most 256 blocks each) cover the
    first to the last listed block, or every block if full_range."""
    idx = sorted(blocks)
    xx1, xx2 = (0, nb - 1) if full_range or not idx else (idx[0], idx[-1])
    bt = []
    for i in range(xx1, xx2 + 1):
        t = blocks[i][0] if i in blocks else 0
        if bt and bt[-1][0] == t and bt[-1][1] < 256:
            bt[-1][1] += 1
        else:
            bt.append([t, 1])
    parts = {"bt": [np.asarray(bt, np.int32).reshape(-1, 2)],
             "sxy": [np.asarray([blocks[i][1]], np.int32) for i in idx if blocks[i][1] is not None],
             "mv": [np.asarray([blocks[i][2]], np.int32) for i in idx if blocks[i][2] is not None],
             "rec": [blocks[i][3] for i in idx], "col": [blocks[i][4] for i in idx]}
    recs = {name: np.concatenate([np.zeros((0, SECTION_WIDTHS[name]), np.int32)]
                                 + [np.asarray(a, np.int32).reshape(-1, SECTION_WIDTHS[name])
                                    for a in parts[name]])
            for name in SECTION_WIDTHS}
    n_data = sum(blocks[i][0] in (1, 2) for i in idx)
    return recs, [len(recs[name]) for name in SECTION_WIDTHS] + [xx1, xx2, n_data]


def _rebuild_as_blocks(fixture, rng):
    """The slots of a rebuild fixture as data blocks of P frames, one a
    stream: each slot's rect in the block that holds its top-left corner
    (clamped to the frame's blocks; the first slot of a block kept), a full
    data block where the rect is the whole block, else a partial one whose
    sub-rect gives the rect (damaged rects give sub-rects outside the
    block); its records up to the last one of nonzero length. Two full
    motion blocks join each stream."""
    _, prev, rects, bsid, pt, rl, lt, _ = fixture
    c, h, w = prev.shape[:3]
    nbx, nby = -(-w // 16), -(-h // 16)
    streams = [{} for _ in range(c)]
    for (x1, y1, x2, y2), s, p_, r_, l_ in zip(rects.tolist(), bsid.tolist(), pt, rl, lt):
        i = min(max(y1 // 16, 0), nby - 1) * nbx + min(max(x1 // 16, 0), nbx - 1)
        if i in streams[s]:
            continue
        x_lo, y_lo, x_hi, y_hi = _block_rect(i, nbx, h, w)
        full = (x1, y1, x2, y2) == (x_lo, y_lo, x_hi, y_hi)
        sub = None if full else (x1 - x_lo, y1 - y_lo, x2 - x_lo - 1, y2 - y_lo - 1)
        n = int(np.flatnonzero(r_).max()) + 1 if r_.any() else 0
        recs = np.stack([p_[:n], r_[:n]], 1).astype(np.int32)
        streams[s][i] = (1 if full else 2, sub, None, recs, l_[:n][p_[:n] == 0])
    for blocks in streams:
        for i in [i for i in range(nbx * nby) if i not in blocks][:2]:
            x1, y1, x2, y2 = _block_rect(i, nbx, h, w)
            mv = (int(rng.integers(-x1, w - x2 + 1)), int(rng.integers(-y1, h - y2 + 1)))
            blocks[i] = (3, None, mv, np.zeros((0, 2), np.int32), np.zeros((0, 3), np.int32))
    return streams, h, w


def _garbage_sections(rng, nb, n_max):
    """A damaged stream's sections as a section decode can give them: every
    field in its symbol range (bt types 0-4, runs 1-256, sub-rect fields
    0-15, motion -256..255, ptypes 0-5, run lengths 1-256, literals 0-255),
    counts and the xx range drawn at random."""
    n = {name: int(rng.integers(0, n_max)) for name in SECTION_WIDTHS}
    recs = {"bt": np.stack([rng.integers(0, 5, n["bt"]), rng.integers(1, 257, n["bt"])], 1),
            "sxy": rng.integers(0, 16, (n["sxy"], 4)),
            "mv": rng.integers(-256, 256, (n["mv"], 2)),
            "rec": np.stack([rng.integers(0, 6, n["rec"]), rng.integers(1, 257, n["rec"])], 1),
            "col": rng.integers(0, 256, (n["col"], 3))}
    xx1 = int(rng.integers(0, nb))
    row = [n[name] for name in SECTION_WIDTHS] + [xx1, int(rng.integers(xx1, nb)),
                                                  int(rng.integers(0, n_max))]
    return {k: v.astype(np.int32) for k, v in recs.items()}, row


def _damage(rng, kind, recs, row):
    """One kind of damage to a clean stream's sections or header row (in
    place): the counts, a run, a sub-rect, a motion vector, run lengths,
    literals."""
    names = list(SECTION_WIDTHS)
    if kind == "n_data":
        row[7] += 1
    elif kind == "bt_run" and len(recs["bt"]):
        recs["bt"][int(rng.integers(len(recs["bt"]))), 1] += 2
    elif kind == "sub_rect" and len(recs["sxy"]):
        recs["sxy"][0, 2] = 15  # may pass the block's right edge
        recs["sxy"][-1, 0] = recs["sxy"][-1, 2] + 1  # x1 > x2
    elif kind == "mv" and len(recs["mv"]):
        recs["mv"][0] = (-255, 255)
    elif kind == "rl" and len(recs["rec"]):
        recs["rec"][len(recs["rec"]) // 2, 1] += 3
    elif kind == "extra_records":
        extra = np.stack([np.zeros(300, np.int32), np.ones(300, np.int32)], 1)
        recs["rec"] = np.concatenate([recs["rec"], extra])
        row[names.index("rec")] += 300
    elif kind == "literals":
        row[names.index("col")] = max(row[names.index("col")] - 2, 0)
    elif kind == "counts":
        row[names.index("sxy")] += 1
        row[names.index("mv")] = max(row[names.index("mv")] - 1, 0)
    elif kind == "xx":
        row[5] += 1


DAMAGE_KINDS = ("n_data", "bt_run", "sub_rect", "mv", "rl", "extra_records", "literals",
                "counts", "xx")


def resolve_fixtures(seed=95):
    """The block resolution's fixtures: name -> (streams' section records
    [{name: [n, W] int32}], header rows, h, w), from a seed with numpy.

    rebuild_<name>: the rebuild fixtures' slots as data blocks
      (_rebuild_as_blocks): every predictor type, frame edges, partial
      blocks of a 37 x 53 frame, empty and inverted rects, three streams,
      runs past a block and zero-length runs;
    clean: a 37 x 53 frame of every block type, partial edge blocks;
    streams: five streams of 48 x 64, one without data blocks, one without
      motion blocks, one with a single changed block, one whose runs cover
      every block;
    chunks: two streams of 160 x 96 (60 blocks; 300-800 records a stream);
    damaged: nine streams of 48 x 64, stream k + 1 with DAMAGE_KINDS[k], the
      first clean;
    garbage: three streams of 48 x 64 of random symbols and counts beside a
      clean one."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, fix in sorted(rebuild_fixtures().items()):
        streams, h, w = _rebuild_as_blocks(fix, rng)
        nb = -(-w // 16) * -(-h // 16)
        made = [stream_sections(b, nb) for b in streams]
        out[f"rebuild_{name}"] = ([m[0] for m in made], [m[1] for m in made], h, w)

    def clean(h, w, n, **kw):
        nb = -(-w // 16) * -(-h // 16)
        full = kw.pop("full_range", [False] * n)
        ps = kw.pop("p_types", [(0.5, 0.15, 0.1, 0.15, 0.1)] * n)
        made = [stream_sections(random_blocks(rng, h, w, p_types=p, **kw), nb, full_range=f)
                for p, f in zip(ps, full)]
        return [m[0] for m in made], [m[1] for m in made]

    out["clean"] = (*clean(37, 53, 1, p_types=[(0.2, 0.2, 0.2, 0.2, 0.2)]), 37, 53)
    out["streams"] = (*clean(48, 64, 5, p_types=[(0.5, 0.15, 0.1, 0.15, 0.1),
                                                 (0.6, 0.0, 0.0, 0.2, 0.2),
                                                 (0.6, 0.2, 0.2, 0.0, 0.0),
                                                 (0.92, 0.08, 0.0, 0.0, 0.0),
                                                 (0.3, 0.2, 0.2, 0.2, 0.1)],
                             full_range=[False, False, False, False, True]), 48, 64)
    out["chunks"] = (*clean(96, 160, 2, p_types=[(0.3, 0.3, 0.2, 0.1, 0.1)] * 2, max_run=4),
                     96, 160)
    recs, rows = clean(48, 64, len(DAMAGE_KINDS) + 1, p_types=[(0.3, 0.25, 0.25, 0.1, 0.1)]
                       * (len(DAMAGE_KINDS) + 1))
    for k, kind in enumerate(DAMAGE_KINDS):
        _damage(rng, kind, recs[k + 1], rows[k + 1])
    out["damaged"] = (recs, rows, 48, 64)
    recs, rows = clean(48, 64, 1)
    for _ in range(3):
        r, row = _garbage_sections(rng, 12, 60)
        recs.append(r)
        rows.append(row)
    out["garbage"] = (recs, rows, 48, 64)
    return out


def resolve_inputs(streams, rows, h, w, device="cpu"):
    """Streams' section records and header rows -> (records {name: [C, cap,
    W] int32} as a decode step gives them (rows past a stream's count 0,
    cap the step's largest count, at least 1), pframe.StepLayout, the
    port's CodecConfig), on `device`."""
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch.config import CodecConfig

    lay = tp.step_layout(rows, device)
    recs = {}
    for name, cap in zip(tp.SECTION_NAMES, lay.caps):
        a = np.zeros((len(streams), cap, SECTION_WIDTHS[name]), np.int32)
        for s, st in enumerate(streams):
            a[s, :len(st[name])] = st[name][:cap]
        recs[name] = torch.as_tensor(a, device=device)
    return recs, lay, CodecConfig(width=w, height=h)


@contextlib.contextmanager
def resolve_calls(store):
    """While the block runs, append to `store` the inputs (recs, lay, cfg)
    of each pframe.rebuild_p_streams call, wherever it is called from."""
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch.parallel import serving as ts

    real = tp.rebuild_p_streams

    def spy(recs, lay, prev, cfg):
        store.append((recs, lay, cfg))
        return real(recs, lay, prev, cfg)

    tp.rebuild_p_streams = ts.rebuild_p_streams = spy
    try:
        yield store
    finally:
        tp.rebuild_p_streams = ts.rebuild_p_streams = real
