"""The serving decoder's step parse (`BatchedDecoder._parse`: every
section of a step's coded streams cut into one [C, K, L] array from the
lane tables `bitstream.read_section` reads) against the per-stream parse
it replaced, kept here as a plain loop: the reference package's
`bitstream.unpack_section`, one zero-padded row a lane, the streams'
arrays stacked. Steps mix flat, raw, no-change, coded I and coded P
streams; size tables of width 1, 2 and 4 and zero-length lanes; k_fixed 8
and 256. The upload arrays must be byte-identical and in the same order,
the plan equal. Damaged containers raise the per-stream parse's message
under the first damaged stream's name."""

import numpy as np
import pytest

from screenpressor_tpu import bitstream as ref_bs
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch.config import ALG_FLAT, ALG_I, ALG_P, ALG_RAW, CodecConfig
from screenpressor_tpu_torch.iframe import i_geometry
from screenpressor_tpu_torch.parallel import serving as ts
from screenpressor_tpu_torch.pframe import AREA, SECTION_NAMES, header_row, step_layout_host

from tests.test_spec_iframe import synth_desktop
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)

H, W = 32, 48


def cfg_of(k):
    return CodecConfig(width=W, height=H, kf_interval=4, k_fixed=k, msr_x=8, msr_y=8)


# -- the per-stream parse, as it was -----------------------------------------------

def plain_pad(blobs, k):
    pay = np.zeros((k, max(max((len(b) for b in blobs), default=0), 4)), np.uint8)
    for i, b in enumerate(blobs):
        pay[i, :len(b)] = np.frombuffer(b, np.uint8)
    return pay


def plain_stack(pays):
    out = np.zeros((len(pays),) + pays[0].shape[:1] + (max(p.shape[1] for p in pays),),
                   np.uint8)
    for j, p in enumerate(pays):
        out[j, :, :p.shape[1]] = p
    return out


def plain_p(data, cfg):
    flags = data[1]
    if not flags & 1:
        return None
    (xx1, xx2, n_bt, n_sxy, n_mv, n_pix, n_lit, n_data), pos = ref_bs.read_varint(data, 2, 8)
    nb = cfg.nbx * cfg.nby
    if not xx1 <= xx2 < nb:
        raise bs.CorruptStreamError("xx block range out of bounds")
    if max(n_bt, n_sxy, n_mv, n_data) > nb or n_pix > nb * AREA or n_lit > n_pix:
        raise bs.CorruptStreamError("section counts out of bounds")
    if n_bt == 0:
        raise bs.CorruptStreamError("empty block-type section")
    ns = dict(zip(SECTION_NAMES, (n_bt, n_sxy, n_mv, n_pix, n_lit)))
    pays = {}
    for name in SECTION_NAMES:
        blobs, pos = ref_bs.unpack_section(data, pos, cfg.k_fixed)
        pays[name] = plain_pad(blobs, cfg.k_fixed)
    return pays, ns, (xx1, xx2, n_data)


def plain_i(data, cfg):
    (n_rec, n_lit), pos = ref_bs.read_varint(data, 1, 2)
    if n_rec > cfg.width * cfg.height or n_lit > max(n_rec, 1):
        raise bs.CorruptStreamError("I-frame record counts out of bounds")
    k_rec, _, k_col, _ = i_geometry(n_rec, n_lit, cfg)
    rec, pos = ref_bs.unpack_section(data, pos, k_rec)
    col, pos = ref_bs.unpack_section(data, pos, k_col)
    return plain_pad(rec, k_rec), plain_pad(col, k_col), n_rec, n_lit


def plain_parse(dec, payloads):
    """The decoder's host half as the per-stream parse gave it: (plan,
    upload arrays); advances dec's flat bookkeeping the same way."""
    cfg, s = dec.cfg, dec.s
    renew = np.zeros(s, bool)
    raws, flats, i_parse, p_parse = {}, {}, {}, {}
    for i, data in enumerate(payloads):
        if not data:
            raise bs.CorruptStreamError(f"stream {i}: empty frame")
        alg = data[0] & 0x0F
        if alg == ALG_FLAT:
            color = np.frombuffer(data[1:4], np.uint8)
            if not (dec.last_flat[i] and (dec.flat_color[i] == color).all()):
                renew[i] = True
                dec.flat_color[i] = color
            dec.last_flat[i] = True
            flats[i] = color
            continue
        dec.last_flat[i] = False
        try:
            if alg == ALG_RAW:
                raws[i] = np.frombuffer(data, np.uint8, H * W * 3, 1).reshape(H, W, 3)
                renew[i] = True
            elif alg == ALG_I:
                renew[i] = True
                i_parse[i] = plain_i(data, cfg)
            else:
                p_parse[i] = plain_p(data, cfg)
        except (bs.CorruptStreamError, ref_bs.CorruptStreamError) as e:
            raise bs.CorruptStreamError(f"stream {i}: {e}") from None
    coded_p = [i for i, x in p_parse.items() if x is not None]
    p_mask = np.zeros(s, bool)
    p_mask[coded_p] = True
    plan = {"renew": bool(renew.any()), "i_ids": list(i_parse), "p_ids": coded_p,
            "raw": bool(raws), "flat": bool(flats), "p_mask": p_mask,
            "checked": bool(i_parse or coded_p)}
    host = [np.nonzero(renew)[0]] if plan["renew"] else []
    if i_parse:
        ids = plan["i_ids"]
        plan["i_n"] = [(i_parse[i][2], i_parse[i][3]) for i in ids]
        host += [np.asarray(ids, np.int64), plain_stack([i_parse[i][0] for i in ids]),
                 plain_stack([i_parse[i][1] for i in ids])]
    if coded_p:
        rows = [header_row(p_parse[i][1], *p_parse[i][2]) for i in coded_p]
        lay_host, plan["p_layout"] = step_layout_host(rows)
        host += [np.asarray(coded_p, np.int64), lay_host]
        host += [plain_stack([p_parse[i][0][name] for i in coded_p]) for name in SECTION_NAMES]
    if raws:
        host += [np.asarray(list(raws), np.int64), np.stack(list(raws.values()))]
    if flats:
        host += [np.asarray(list(flats), np.int64), np.stack(list(flats.values()))]
    return plan, host


def assert_same_parse(got, want, what):
    (plan, host), (plan_w, host_w) = got, want
    assert plan.keys() == plan_w.keys(), what
    for key in plan:
        if key == "p_mask":
            np.testing.assert_array_equal(plan[key], plan_w[key], err_msg=what)
        else:
            assert plan[key] == plan_w[key], (what, key)
    assert len(host) == len(host_w), what
    for j, (a, b) in enumerate(zip(host, host_w)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, j, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), (what, j)


def parse_both(dec, ref, payloads, have_prev=True):
    """dec's step parse and the plain parse on ref (a twin of dec); both
    decoders' flat bookkeeping is compared after."""
    want = plain_parse(ref, payloads)
    got = dec._parse(payloads, lambda i: f"stream {i}", have_prev=have_prev)
    np.testing.assert_array_equal(dec.last_flat, ref.last_flat)
    np.testing.assert_array_equal(dec.flat_color, ref.flat_color)
    return got, want


# -- steps of an encoded session ---------------------------------------------------

def session_batches(steps=6):
    """Stream 0 scrolls, 1 types, 2 idles (no-change P), 3 is flat, 4 is
    noise (RAW), 5 keyframes every step the encoder's kf_interval asks."""
    base = synth_desktop(H + 4 * steps, W, seed=31)
    typing = synth_desktop(H, W, seed=32)
    idle = synth_desktop(H, W, seed=33)
    rng = np.random.default_rng(34)
    batches = []
    for t in range(steps):
        typing = typing.copy()
        typing[3 + 4 * t:6 + 4 * t, 5 + 6 * t:9 + 6 * t] = rng.integers(0, 256, 3)
        kf = idle.copy()
        kf[(5 * t) % H:(5 * t) % H + 4, 8:40] = (30 * t, 90, 200)
        batches.append(np.stack([
            base[2 * t:2 * t + H], typing, idle, np.full((H, W, 3), (7, 8, 9), np.uint8),
            rng.integers(0, 256, (H, W, 3), dtype=np.uint8), kf]))
    return batches


@pytest.mark.parametrize("k", [8, 256])
def test_step_parse_equals_per_stream_parse_on_a_session(k):
    cfg = cfg_of(k)
    enc = ts.BatchedEncoder(6, cfg, "cpu", kf_offsets=[0, 0, 0, 0, 0, 1])
    dec, ref = ts.BatchedDecoder(6, cfg, "cpu"), ts.BatchedDecoder(6, cfg, "cpu")
    kinds = set()
    for t, frames in enumerate(session_batches()):
        payloads = [p for p, _ in enc.encode(frames)]
        kinds |= {(p[0] & 0x0F, p[0] & 0x0F == ALG_P and bool(p[1] & 1)) for p in payloads}
        assert_same_parse(*parse_both(dec, ref, payloads, have_prev=t > 0), f"step {t}")
    assert kinds == {(ALG_I, False), (ALG_P, True), (ALG_P, False), (ALG_FLAT, False),
                     (ALG_RAW, False)}, kinds


# -- synthetic steps: every size-table width, zero-length lanes ----------------------

def lanes(rng, k, widest, zeros=0.4):
    """k lane payloads of 0-11 bytes, about `zeros` of them empty, and one
    lane, drawn at random, `widest` bytes long."""
    sizes = np.where(rng.random(k) < zeros, 0, rng.integers(1, 12, k))
    sizes[rng.integers(k)] = widest
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


def p_frame(rng, cfg, widest=11):
    nb = cfg.nbx * cfg.nby
    counts = [int(rng.integers(1, nb + 1)), int(rng.integers(0, nb)), int(rng.integers(0, nb)),
              int(rng.integers(0, 300)), 0]
    counts[4] = int(rng.integers(0, counts[3] + 1))
    xx1 = int(rng.integers(0, nb))
    big = int(rng.integers(len(SECTION_NAMES)))
    return (bytes([bs.header_byte(ALG_P), 1])
            + bs.pack_varint(xx1, int(rng.integers(xx1, nb)), *counts, int(rng.integers(0, nb)))
            + b"".join(bs.pack_section(lanes(rng, cfg.k_fixed, widest if j == big else 11))
                       for j in range(len(SECTION_NAMES))))


def i_frame(rng, cfg, widest=11):
    n_rec = int(rng.integers(1, H * W))
    return (bytes([bs.header_byte(ALG_I)]) + bs.pack_varint(n_rec, int(rng.integers(0, n_rec)))
            + bs.pack_section(lanes(rng, cfg.k_fixed, widest))
            + bs.pack_section(lanes(rng, cfg.k_fixed, 11)))


def synthetic_step(rng, cfg, widths=(1, 1)):
    """[flat, raw, no-change P, coded I, coded P, flat, coded P, coded I]:
    the I stream 3's rec section and the P stream 6's widest section have
    size tables of widths[0] and widths[1] bytes."""
    widest = {1: 200, 2: 300, 4: 1 << 16}
    return [bytes([bs.header_byte(ALG_FLAT), 1, 2, 3]),
            bytes([bs.header_byte(ALG_RAW)]) + rng.integers(0, 256, H * W * 3,
                                                            dtype=np.uint8).tobytes(),
            bytes([bs.header_byte(ALG_P), 0]),
            i_frame(rng, cfg, widest[widths[0]]), p_frame(rng, cfg),
            bytes([bs.header_byte(ALG_FLAT), 4, 5, 6]),
            p_frame(rng, cfg, widest[widths[1]]), i_frame(rng, cfg)]


def section_tables(data, cfg):
    """(width, lane sizes) of each section of a coded container."""
    if data[0] & 0x0F == ALG_I:
        pos, n = ref_bs.read_varint(data, 1, 2)[1], 2
    else:
        pos, n = ref_bs.read_varint(data, 2, 8)[1], len(SECTION_NAMES)
    out = []
    for _ in range(n):
        width = (1, 2, 4)[(data[pos] >> 4) & 3]
        blobs, pos = ref_bs.unpack_section(data, pos, cfg.k_fixed)
        out.append((width, [len(b) for b in blobs]))
    return out


@pytest.mark.parametrize("k", [8, 256])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_step_parse_equals_per_stream_parse_at_each_width(width, k):
    cfg, rng = cfg_of(k), np.random.default_rng(100 * width + k)
    # a 4-byte table in a keyframe only: its 64 KiB lane widens only the keyframes' rec array
    widths = (width, min(width, 2))
    dec, ref = ts.BatchedDecoder(8, cfg, "cpu"), ts.BatchedDecoder(8, cfg, "cpu")
    tables = []
    for t in range(3):
        payloads = synthetic_step(rng, cfg, widths)
        tables += [tb for j in (3, 4, 6, 7) for tb in section_tables(payloads[j], cfg)]
        assert_same_parse(*parse_both(dec, ref, payloads), f"step {t}")
    assert max(w for w, _ in tables) == width
    assert sum(sizes.count(0) for _, sizes in tables) > len(tables)


# -- damaged containers: the first damaged stream is named -----------------------------

def damage(data, case, cfg):
    """A coded container with `case` planted in its third section (an I
    frame's second, of two), and the per-stream parse's message for it."""
    if data[0] & 0x0F == ALG_I:
        pos = ref_bs.read_varint(data, 1, 2)[1]
        pos = ref_bs.unpack_section(data, pos, cfg.k_fixed)[1]
    else:
        pos = ref_bs.read_varint(data, 2, 8)[1]
        for _ in range(2):
            pos = ref_bs.unpack_section(data, pos, cfg.k_fixed)[1]
    status, klog = data[pos], cfg.k_fixed.bit_length() - 1
    bad = {"section_header": data[:pos],
           "width_code": data[:pos] + bytes([klog | 3 << 4]) + data[pos + 1:],
           "lane_count": data[:pos] + bytes([(status & 0xF0) | (klog + 1)]) + data[pos + 1:],
           "size_table": data[:pos + 2],
           "lane_payload": data[:-1]}[case]
    want = {"section_header": "truncated section header",
            "width_code": "bad section width code 3",
            "lane_count": f"lane count mismatch: stream {2 * cfg.k_fixed}, policy {cfg.k_fixed}",
            "size_table": "truncated lane size table",
            "lane_payload": "truncated lane payload"}[case]
    return bad, want


CASES = ["section_header", "width_code", "lane_count", "size_table", "lane_payload"]


@pytest.mark.parametrize("kind", ["I", "P"])
@pytest.mark.parametrize("at", [0, 3, 7])
@pytest.mark.parametrize("case", CASES)
def test_damaged_container_names_first_damaged_stream(case, at, kind):
    """Stream `at` of a step of 8 coded streams carries the damage (and,
    unless it is the last, stream 7 another one): the step raises the
    per-stream parse's message under stream `at`'s name, and the flat
    bookkeeping advances as the per-stream parse's did."""
    cfg, rng = cfg_of(8), np.random.default_rng(CASES.index(case))
    make = {"I": i_frame, "P": p_frame}[kind]
    payloads = [bytes([bs.header_byte(ALG_FLAT), 9, 9, i]) if i % 3 == 1 else
                (p_frame if i % 2 else i_frame)(rng, cfg) for i in range(8)]
    payloads[at], want = damage(make(rng, cfg), case, cfg)
    if at < 7:
        payloads[7] = damage(p_frame(rng, cfg), "lane_payload", cfg)[0]
    dec, ref = ts.BatchedDecoder(8, cfg, "cpu"), ts.BatchedDecoder(8, cfg, "cpu")
    with pytest.raises(bs.CorruptStreamError) as plain:
        plain_parse(ref, payloads)
    with pytest.raises(bs.CorruptStreamError) as got:
        dec._parse(payloads, lambda i: f"stream {i}", have_prev=True)
    assert str(got.value) == str(plain.value) == f"stream {at}: {want}"
    np.testing.assert_array_equal(dec.last_flat, ref.last_flat)
    np.testing.assert_array_equal(dec.flat_color, ref.flat_color)
