"""wgbstools-compatible CLI dispatcher.

Command names match the reference's surface (ref: src/python/wgbs_tools.py:
11-48) so users can switch with their muscle memory intact; dispatch is a
static registry instead of importlib-on-argv patching.
"""

import argparse
import difflib
import os
import sys

from ..utils import IllegalArgumentError, eprint


def _lazy(module, fn="main"):
    def runner(argv):
        import importlib

        mod = importlib.import_module(f"wgbs_tools_tpu.cli.{module}")
        return getattr(mod, fn)(argv)

    return runner


COMMANDS = {
    # view
    "vis": _lazy("cmd_vis"),
    "view": _lazy("cmd_view"),
    "cview": _lazy("cmd_view", "main_cview"),
    "convert": _lazy("cmd_convert"),
    "pat_fig": _lazy("cmd_vis", "main_pat_fig"),
    # beta ops
    "beta_to_blocks": _lazy("cmd_beta", "main_beta_to_blocks"),
    "beta_to_table": _lazy("cmd_beta", "main_beta_to_table"),
    "beta2bed": _lazy("cmd_beta", "main_beta2bed"),
    "beta2bw": _lazy("cmd_beta", "main_beta2bw"),
    "beta_cov": _lazy("cmd_beta", "main_beta_cov"),
    "beta_stats": _lazy("cmd_beta", "main_beta_stats"),
    "beta_to_450k": _lazy("cmd_beta", "main_beta_to_450k"),
    "compare_betas": _lazy("cmd_beta", "main_compare_betas"),
    # generation
    "init_genome": _lazy("cmd_genome", "main_init_genome"),
    "set_default_ref": _lazy("cmd_genome", "main_set_default_ref"),
    "bam2pat": _lazy("cmd_bam2pat"),
    "index": _lazy("cmd_pat", "main_index"),
    "pat2beta": _lazy("cmd_pat", "main_pat2beta"),
    "bed2beta": _lazy("cmd_beta", "main_bed2beta"),
    "lbeta2beta": _lazy("cmd_beta", "main_lbeta2beta"),
    "mix_pat": _lazy("cmd_pat", "main_mix_pat"),
    "merge": _lazy("cmd_pat", "main_merge"),
    "mask_pat": _lazy("cmd_pat", "main_mask_pat"),
    # analysis
    "segment": _lazy("cmd_segment"),
    "homog": _lazy("cmd_homog"),
    "find_markers": _lazy("cmd_markers"),
    "add_cpg_counts": _lazy("cmd_bam2pat", "main_add_cpg_counts"),
    "frag_len": _lazy("cmd_pat", "main_frag_len"),
    "split_by_allele": _lazy("cmd_bam2pat", "main_split_by_allele"),
    "split_by_meth": _lazy("cmd_bam2pat", "main_split_by_meth"),
    "test_bimodal": _lazy("cmd_markers", "main_test_bimodal"),
    # extras beyond the reference's registered commands
    "pat2pairs": _lazy("cmd_misc", "main_pat2pairs"),
    "mbias_plot": _lazy("cmd_misc", "main_mbias_plot"),
    "worker": _lazy("worker"),
}


def compile_cache_dir():
    """JAX's persistent compilation cache directory: JAX_COMPILATION_CACHE_DIR
    when set, else `.jax_cache` at the root of this checkout (a fixed path,
    so every process of the checkout hits the same entries)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")


def ensure_compile_cache():
    """Point JAX's persistent compilation cache at compile_cache_dir().
    With JAX_COMPILATION_CACHE_DIR set, JAX already uses it and nothing
    is changed."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    d = compile_cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ensure_compile_cache()
    parser = argparse.ArgumentParser(
        prog="wgbstools-tpu",
        description="GPU-accelerated tools for WGBS methylation data "
        "(pat/beta formats)",
    )
    parser.add_argument("command", nargs="?", help="|".join(COMMANDS))
    parser.add_argument("--version", action="store_true")
    args, rest = parser.parse_known_args(argv[:1])
    if args.version:
        from .. import __version__

        print(__version__)
        return 0
    cmd = args.command
    if cmd is None:
        parser.print_help()
        return 1
    if cmd not in COMMANDS:
        eprint(f"Invalid command: {cmd}")
        close = difflib.get_close_matches(cmd, COMMANDS.keys())
        if close:
            eprint("did you mean", " or ".join(close), "?")
        return 1
    if cmd != "worker" and os.environ.get("WGBS_TPU_WORKER") == "1":
        # transparent routing: run on the persistent worker when one is up
        # (keeps device state warm across invocations); in-process
        # execution only when no worker is listening
        from .worker import run_via_worker

        rc = run_via_worker(argv)
        if rc is not None:
            return rc
    try:
        return COMMANDS[cmd](argv[1:]) or 0
    except IllegalArgumentError as e:
        eprint(f"[wt {cmd}] error: {e}")
        return 1
    except BrokenPipeError:
        return 0


def add_gr_args(parser, bed_file=False, no_anno=False):
    """Shared region flags (ref: utils_wgbs.py:233-247)."""
    g = parser.add_mutually_exclusive_group()
    g.add_argument("-s", "--sites", help='CpG index range, e.g. "450000-450050"')
    g.add_argument("-r", "--region", help='genomic region, e.g. "chr1:10,000-10,500"')
    g.add_argument("--array_id", help="Illumina array id, e.g. cg00001755")
    if bed_file:
        g.add_argument("-L", "--bed_file", help="bed file with CpG columns 4-5")
    if no_anno:
        parser.add_argument("--no_anno", action="store_true",
                            help="do not print genome annotations")
    parser.add_argument("--genome", default=None, help="genome reference name")
    return parser


def add_view_args(parser, out_path=True, sub_sample=True):
    parser.add_argument("--strict", action="store_true",
                        help="truncate reads outside the region")
    parser.add_argument("--strip", action="store_true",
                        help="remove leading/trailing dots")
    parser.add_argument("--min_len", type=int, default=1,
                        help="only reads covering >= MIN_LEN CpGs")
    parser.add_argument("--no_gaps", action="store_true",
                        help="drop reads with unknown (.) sites")
    if sub_sample:
        parser.add_argument("--sub_sample", type=float, help="subsample rate")
    parser.add_argument("--no_sort", action="store_true")
    parser.add_argument("--shuffle", action="store_true",
                        help="random order of reads sharing a start site "
                             "(ref: cview.py:43-46, sort -k3,3R)")
    parser.add_argument("-np", "--nanopore", action="store_true",
                        help="(compat; ref cview.py:34-37 widens the tabix "
                             "back-scan for very long reads — our .cdx "
                             "index records the true max fragment length, "
                             "so overlapping long reads are always pulled)")
    parser.add_argument("--seed", type=int, default=None)
    if out_path:
        parser.add_argument("-o", "--out_path", default=None)
    return parser


if __name__ == "__main__":
    sys.exit(main())
