"""Batched device->host fetch.

`jax.device_get` on a multi-leaf pytree can make one blocking transfer
per leaf, and each blocking pull waits for the device and pays a
transfer's fixed cost. Pipelines pull many small summaries (costs,
counts, flags) at a time, so the cheap shape is a SINGLE transfer.

`fetch` therefore ravels and concatenates all device-array leaves of the
tree into one buffer per dtype on device (async dispatch, no host sync),
pulls each bucket in one transfer, and splits it back on host. A
20-scalar summary pull is one transfer instead of up to 20. Leaves of an
extended dtype (PRNG keys) cannot be concatenated or viewed as NumPy
arrays; each is pulled on its own with `jax.device_get`.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def fetch(tree):
    """Pull a pytree of device arrays to host in ~one transfer per dtype."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = list(leaves)
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        if not isinstance(x, jax.Array):
            continue
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.extended):
            out[i] = jax.device_get(x)
        else:
            by_dtype.setdefault(np.dtype(x.dtype), []).append(i)
    buckets = []
    for dt, idxs in by_dtype.items():
        flats = [jnp.ravel(leaves[i]) for i in idxs]
        buckets.append(
            (idxs, jnp.concatenate(flats) if len(flats) > 1 else flats[0])
        )
    datas = jax.device_get([b for (_, b) in buckets])
    for (idxs, _), data in zip(buckets, datas):
        data = np.asarray(data)
        off = 0
        for i in idxs:
            shape = leaves[i].shape
            n = math.prod(shape) if shape else 1
            out[i] = data[off : off + n].reshape(shape)
            off += n
    return jax.tree_util.tree_unflatten(treedef, out)
