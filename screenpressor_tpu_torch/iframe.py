"""I-frame encode/decode — PyTorch port of `screenpressor_tpu/jx/iframe.py`.

Classification, lane dealing, the two section codes (rec, col) and the
reconstruction run on the device; the host reads the record counts once
to pick lane counts and assembles the container.
"""

from __future__ import annotations

import torch

from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch.config import CodecConfig
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch.container import frame_bytes, i_head, raw_escape
from screenpressor_tpu_torch.classify import classify_i
from screenpressor_tpu_torch.recon import reconstruct_i
from screenpressor_tpu_torch.tables import renew_tables_cached, select_tables

I32 = torch.int32


def i_phase(frame: torch.Tensor):
    """Keyframe analysis: classification + flat check. Returns (records,
    lits, counts [7] = n_rec, n_lit, is_flat, r, g, b, touched color rows,
    touched-row bitmap) on the device."""
    records, n_records, lits, n_literals = classify_i(frame)
    c0 = frame.reshape(-1, 3)[0]
    is_flat = (frame == c0).all()
    bm = tc.color_touched_bitmap(lits, n_literals)
    counts = torch.cat([torch.stack([n_records, n_literals, is_flat.to(I32)]),
                        c0.to(I32), bm.sum(dtype=I32).reshape(1)])
    return records, lits, counts, bm


def i_geometry(n_rec: int, n_lit: int, cfg: CodecConfig):
    """(k_rec, t_rec, k_col, t_col) for a keyframe's two sections."""
    k_rec, k_col = cfg.lanes(n_rec), cfg.lanes(n_lit)
    return k_rec, tc.steps_for(n_rec, k_rec), k_col, tc.steps_for(n_lit, k_col)


def encode_i_from_records(records, n_rec: int, lits, n_lit: int, tables: dict,
                          cfg: CodecConfig, col_w=None, col_bm=None):
    """Section encoding of classification outputs (the col section as colw
    when col_w is set). Returns (buf_rec, start_rec, lens_rec, buf_col,
    start_col, lens_col, tables')."""
    k_rec, t_rec, k_col, t_col = i_geometry(n_rec, n_lit, cfg)
    dev = records.device
    lens_rec = tc.lane_lens(n_rec, k_rec, dev)
    lens_col = tc.lane_lens(n_lit, k_col, dev)
    bufs, starts, tables = tc.encode_sections(
        [tc.deal(records, n_rec, k_rec, t_rec), tc.deal(lits, n_lit, k_col, t_col)],
        [lens_rec, lens_col], tables,
        (("rec", k_rec, t_rec), ("col", k_col, t_col)), col_w, col_bm,
    )
    return bufs[0], starts[0], lens_rec, bufs[1], starts[1], lens_col, tables


def encode_i_raw(records, n_rec: int, lits, n_lit: int, tables: dict,
                 cfg: CodecConfig, raw_threshold: int, col_w=None, col_bm=None):
    """encode_i_from_records + exact container size + raw-escape table
    select on the device (the host applies the same size rule when it
    assembles the container). Returns (buf_rec, start_rec, lens_rec,
    buf_col, start_col, lens_col, stats [2] = total, is_raw, tables')."""
    out = encode_i_from_records(records, n_rec, lits, n_lit, tables, cfg, col_w,
                                col_bm)
    buf_rec, start_rec, lens_rec, buf_col, start_col, lens_col, tables2 = out
    total = frame_bytes(i_head(n_rec, n_lit), [buf_rec, buf_col], [start_rec, start_col],
                        [lens_rec, lens_col])
    is_raw = raw_escape(total, raw_threshold)
    sel = select_tables(is_raw, renew_tables_cached(records.device), tables2)
    stats = torch.stack([total, is_raw.to(I32)])
    return buf_rec, start_rec, lens_rec, buf_col, start_col, lens_col, stats, sel


def read_i_container(data: bytes, pos: int, cfg: CodecConfig):
    """Host-side I-frame container parse + sanity bounds, the payload bytes
    left where they lie. Returns (lanes_rec, lanes_col, n_rec, n_lit), each
    lanes a section's bitstream.read_section (sizes, first, end)."""
    (n_rec, n_lit), pos = bs.read_varint(data, pos, 2)
    if n_rec > cfg.width * cfg.height or n_lit > max(n_rec, 1):
        raise bs.CorruptStreamError("I-frame record counts out of bounds")
    k_rec, _, k_col, _ = i_geometry(n_rec, n_lit, cfg)
    lanes_rec = bs.read_section(data, pos, k_rec)
    lanes_col = bs.read_section(data, lanes_rec[2], k_col)
    return lanes_rec, lanes_col, n_rec, n_lit


def parse_i_header(data: bytes, pos: int, cfg: CodecConfig):
    """read_i_container with its sections' lanes as arrays: (pay_rec,
    pay_col, n_rec, n_lit) with [K, L] uint8 numpy payloads."""
    lanes_rec, lanes_col, n_rec, n_lit = read_i_container(data, pos, cfg)
    view = memoryview(data)
    return (*(tc.pad_lanes(view[first:end], sizes)
              for sizes, first, end in (lanes_rec, lanes_col)), n_rec, n_lit)


def decode_i_device(pay_rec: torch.Tensor, pay_col: torch.Tensor, n_rec: int,
                    n_lit: int, tables: dict, cfg: CodecConfig):
    """Returns (frame [H, W, 3] uint8, pixels covered (device scalar),
    tables'). The caller checks the coverage against H * W."""
    k_rec, t_rec, k_col, t_col = i_geometry(n_rec, n_lit, cfg)
    dev = pay_rec.device
    (recs_scan, lits_scan), tables = tc.decode_sections(
        [pay_rec, pay_col],
        [tc.lane_lens(n_rec, k_rec, dev), tc.lane_lens(n_lit, k_col, dev)],
        tables, (("rec", k_rec, t_rec), ("col", k_col, t_col)))
    records = tc.undeal(recs_scan, n_rec, k_rec, max(n_rec, 1))
    lits = tc.undeal(lits_scan, n_lit, k_col, max(n_lit, 1))
    total = records[:, 1].sum(dtype=I32)
    frame = reconstruct_i(records, lits, cfg.height, cfg.width)
    return frame, total, tables
