"""Host values onto the device without a host-to-device copy."""

from __future__ import annotations

import numpy as np
import torch


def ints_on_device(values, device, dtype=torch.int64):
    """``values`` (host ints or bools) as a 1-D tensor on ``device``, each
    written by a fill kernel. A decode step uses this for its few per-row
    values: after a blocking copy PyTorch waits for the stream to drain, and
    a pinned non-blocking copy can block the host too while the pinned
    memory pool grows; a host-bound decode loop loses its overlap with the
    card either way."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in np.asarray(values).reshape(-1).tolist()])
