"""The copies between the host and a device that the port's sessions share;
every copy that waits on the device is a `telemetry.sync` at the caller's
site."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from screenpressor_tpu_torch import telemetry

_NP = {torch.uint8: np.uint8, torch.bool: np.bool_, torch.int32: np.int32,
       torch.int64: np.int64}


def upload(host: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`, without waiting for the device's queue: on
    a CUDA device through pinned memory and a non-blocking copy (a plain
    pageable copy waits for the queue to drain)."""
    t = torch.as_tensor(np.ascontiguousarray(host))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_all(arrays, device) -> list:
    """Host arrays -> the same arrays on `device` in ONE non-blocking upload
    (`upload`); each part starts at a multiple of 8 bytes, so that every
    dtype can view it."""
    if not arrays:
        return []
    chunks, spans, pos = [], [], 0
    for a in arrays:
        b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        chunks += [b, np.zeros(-len(b) % 8, np.uint8)]
        spans.append((pos, len(b)))
        pos += len(b) + len(chunks[-1])
    dev = upload(np.concatenate(chunks), device)
    dtypes = {v: k for k, v in _NP.items()}
    return [dev[o:o + n].view(dtypes[np.dtype(a.dtype).type]).view(a.shape) if n else
            torch.empty(a.shape, dtype=dtypes[np.dtype(a.dtype).type], device=dev.device)
            for (o, n), a in zip(spans, arrays)]


def to_device(host, device, site: str, dtype=None) -> torch.Tensor:
    """A host array or list on `device`: one blocking copy, a host sync at
    `site`."""
    with telemetry.sync(site):
        return torch.as_tensor(host, dtype=dtype, device=device)


def to_host(t: torch.Tensor, site: str) -> np.ndarray:
    """t as a numpy array: one device-to-host copy, a host sync at `site`."""
    with telemetry.sync(site):
        return t.cpu().numpy()


def pull(groups, site: str):
    """One device-to-host copy of lists of tensors, a host sync at `site` ->
    the same lists of numpy arrays (dtype and shape kept)."""
    flat = [t for g in groups for t in g]
    if not flat:
        return [[] for _ in groups]
    raw = to_host(torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                             for t in flat]), site)
    out, pos = [], 0
    for g in groups:
        got = []
        for t in g:
            n = t.numel() * t.element_size()
            got.append(raw[pos: pos + n].view(_NP[t.dtype]).reshape(t.shape))
            pos += n
        out.append(got)
    return out


def owned_frames(frames, device) -> torch.Tensor:
    """Frames (numpy or tensor) as uint8 on `device`, in storage of their
    own: a session keeps the last ones as `prev`, which must not change when
    the caller refills its capture buffer. One copy, contiguous (the kernels
    take raw pointers; an RGB32 frame's RGB view is strided)."""
    if not isinstance(frames, torch.Tensor):
        with telemetry.sync("codec.owned_frames"):
            return torch.tensor(np.ascontiguousarray(frames, np.uint8), device=device)
    crossing = frames.device.type != torch.device(device).type  # host <-> card
    with telemetry.sync("codec.owned_frames") if crossing else telemetry.NOOP:
        return frames.to(device, torch.uint8, copy=True, memory_format=torch.contiguous_format)


def on_device(device):
    """Make `device` current while a group's work is queued (a kernel
    launches on the current device's stream)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
