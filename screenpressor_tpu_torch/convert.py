"""Carry state between the JAX reference and the port as numpy arrays.

The port never imports JAX: these take any array that `np.asarray`
accepts (a JAX array included) and return torch tensors, or the reverse,
so a test can feed identical tables and records to both packages. Table
trees may carry a leading stream axis (the serving sessions' [S, ...]
tables); the shapes pass through unchanged.
"""

from __future__ import annotations

import numpy as np
import torch


def tables_from_jax(tree, device="cpu") -> dict:
    """{kind: {key: array}} -> the port's {kind: {key: int32 tensor}}."""
    return {
        kd: {key: torch.as_tensor(np.asarray(v, np.int32), device=device)
             for key, v in tab.items()}
        for kd, tab in tree.items()
    }


def tables_to_numpy(tables: dict) -> dict:
    """A table tree of either package -> {kind: {key: np.ndarray}} (int32)."""
    return {
        kd: {key: np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                           np.int32)
             for key, v in tab.items()}
        for kd, tab in tables.items()
    }


def array_from_jax(a, device="cpu") -> torch.Tensor:
    """Record / payload / frame array -> tensor of the same dtype (a
    writable copy: arrays read back from JAX are read-only)."""
    return torch.as_tensor(np.array(a), device=device)


def array_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
