"""wgbs_tools_tpu — a GPU-accelerated engine for WGBS/bisulfite/nanopore methylation data.

A from-scratch re-design of the capabilities of nloyfer/wgbs_tools
(reference layout surveyed in /root/repo/SURVEY.md): pat/beta file formats over a
CpG-index coordinate system, BAM -> pat conversion, pileup (pat2beta), block
reductions, fragment-state (U/X/M) counting, change-point segmentation, and
marker discovery — with the hot loops implemented as JAX/XLA device programs
(or host C++ kernels when no GPU is present) and scaled over device meshes,
instead of the reference's Unix-pipe C++ stream filters.

Subpackages
-----------
- ``genome``   : CpG-index coordinate system (ref: src/python/init_genome.py,
                 genomic_region.py, utils_wgbs.py:53-115)
- ``formats``  : BGZF codec, pat/beta/blocks IO (ref: docs/pat_format.md,
                 docs/beta_format.md)
- ``ops``      : device kernels — pileup, block reduce, homog, sampling
- ``models``   : segmentation DP, marker stats, bimodality EM
- ``parallel`` : mesh construction + sharded whole-genome pipelines
- ``pipeline`` : BAM decoding and bam->pat conversion
- ``cli``      : wgbstools-compatible command-line surface
"""

__version__ = "0.1.0"
