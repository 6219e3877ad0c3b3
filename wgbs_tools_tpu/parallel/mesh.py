"""Device mesh construction for genome-axis / sample-axis sharding.

The reference's parallelism is a multiprocessing Pool sharded by chromosome
or 60k-site chunk with order-preserving concat (ref: src/python/bam2pat.py:
303-356, segment.py:137-155). The device mapping: a 2-D mesh with a `sites`
axis (contiguous CpG-index ranges per device, the analogue of
chromosome/chunk sharding) and a `samples` axis (beta files / datasets), with
XLA collectives replacing the filesystem merges:

- per-CpG count assembly  -> halo ppermute + local add (was: concat parts)
- multi-sample cost sums  -> psum over `samples` (was: in-process loop)
- whole-genome gather     -> all_gather over `sites` (was: cat tmp files)
"""

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices=None, samples_axis=1, devices=None):
    """Create a (samples, sites) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % samples_axis != 0:
        raise ValueError(f"{n} devices cannot host {samples_axis} sample shards")
    arr = np.array(devices).reshape(samples_axis, n // samples_axis)
    return Mesh(arr, axis_names=("samples", "sites"))


def pad_to_multiple(x, multiple, axis=0, fill=0):
    """Pad an array along `axis` so its length divides evenly for sharding."""
    n = x.shape[axis]
    target = (n + multiple - 1) // multiple * multiple
    if target == n:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill)
