"""Shared fixture of the port's CPU tests (tests/test_torch_*.py)."""

import dataclasses

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
    import numpy as np

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
    import numpy as np

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
    """(fn(), {stage: ms}): fn run under torch.profiler; for each stage that
    screenpressor_tpu_torch.parallel.mesh labels (a record_function range
    "sp <stage>"), the device time of the kernels and copies launched while
    its range was open on the host, summed over its calls. A device event
    belongs to the host launch call (cudaLaunchKernel, cudaMemcpyAsync, ...)
    with its correlation id; the launch's host time places it in a range.
    The kernels of ctypes launches are joined to no PyTorch op, so the
    ranges' own device totals miss them. Without a CUDA device the times
    are 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
        for i in range(torch.cuda.device_count() if cuda else 0):
            torch.cuda.synchronize(i)
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, e.name[3:]) for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith("sp ")]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    ms = {name: 0.0 for _, _, name in ranges}
    for e in events:
        at = launched.get(e.id)
        if e.device_type != DeviceType.CUDA or e.is_user_annotation or at is None:
            continue
        for lo, hi, name in ranges:
            if lo <= at <= hi:
                ms[name] += (e.time_range.end - e.time_range.start) / 1e3
    return out, ms
