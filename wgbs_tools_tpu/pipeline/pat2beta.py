"""pat -> beta conversion (the pileup pipeline).

Reference flow (ref: src/python/pat2beta.py:14-65): per-chromosome
`tabix | stdin2beta` processes in a Pool, concatenated with numpy and
saturated to uint8. Here the pat file streams through bounded-memory chunks
(formats/pat.py::iter_pat — BGZF slabs inflated by the multithreaded native
decompressor) and each chunk piles up on the GPU (or in the host C++
kernel when there is none). With sharded=True (CLI `--sharded`) the
count table is split by site range over every visible device, each shard
running the XLA scatter on boundary-clipped fragments
(parallel/sharded.py::ShardedPileup). That is opt-in: the job is bound
by host decode, and on a four-H100 host the sharded job measured slower
than one card (PERF.md). Counts are integer adds, so every path is
bit-identical to the reference pileup.
"""

import os.path as op

import jax

from ..formats.pat import iter_pat
from ..ops.pileup import PileupAccumulator
from ..utils import splitextgz
from ..utils.log import logger

# one streamed slab of decompressed pat text (~32 MB ≈ 1M fragments); host
# peak memory stays O(chunk), not O(file)
DEF_CHUNK_BYTES = 32 << 20


def _accumulate_pat(pat_path, nr_sites, backend="auto", sharded=False,
                    chunk_bytes=DEF_CHUNK_BYTES):
    """Stream a pat file into a pileup accumulator. Returns
    (accumulator, nr_frags)."""
    window = (1, nr_sites + 1)
    if sharded and len(jax.devices()) > 1:
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded import ShardedPileup

        acc = ShardedPileup(make_mesh(), window)
    else:
        acc = PileupAccumulator(window, backend=backend)
    nf = 0
    it = iter_pat(pat_path, chunk_bytes=chunk_bytes)
    if getattr(acc, "device_total", True):
        # one-chunk lookahead: the next slab decompresses/parses (native
        # code, GIL released) while the current one stages and piles up on
        # device — add() is mostly device-queue wait, so the host is free
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(next, it, None)
            while True:
                chunk = fut.result()
                if chunk is None:
                    break
                fut = ex.submit(next, it, None)
                acc.add(chunk)
                nf += chunk.nr_frags
        return acc, nf
    # host-total accumulators (native/xla-CPU) are CPU-bound end to end:
    # a lookahead thread only oversubscribes the cores (decode already uses
    # them all), so run the loop inline
    for chunk in it:
        acc.add(chunk)
        nf += chunk.nr_frags
    return acc, nf


def pat2beta(pat_path, out_dir=".", genome=None, lbeta=False, backend="auto",
             force=True, out_path=None, sharded=False,
             chunk_bytes=DEF_CHUNK_BYTES):
    """Convert a pat[.gz] file to a beta/lbeta file. Returns the output path."""
    from ..genome.refdir import Genome

    g = genome if genome is not None else Genome(None)
    nr_sites = g.get_nr_sites() if hasattr(g, "get_nr_sites") else g.nr_sites

    acc, nf = _accumulate_pat(pat_path, nr_sites, backend=backend,
                              sharded=sharded, chunk_bytes=chunk_bytes)

    suff = ".lbeta" if lbeta else ".beta"
    if out_path is None:
        out_path = op.join(out_dir, splitextgz(op.basename(pat_path))[0] + suff)
    acc.finalize(lbeta).tofile(out_path)
    logger.info("pat2beta: %s -> %s (%d frags, %d sites)", pat_path, out_path,
                nf, nr_sites)
    return out_path


def pat2beta_counts(pat_path, nr_sites, backend="auto", sharded=False):
    """Raw (nr_sites, 2) int counts (pre-saturation) for a pat file."""
    acc, _ = _accumulate_pat(pat_path, nr_sites, backend=backend,
                             sharded=sharded)
    return acc.result()
