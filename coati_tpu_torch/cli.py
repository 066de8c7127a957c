"""Command-line interface: coati-tpu-torch <verb> (counterpart of
coati_tpu/cli.py).

Ported verbs: alignpair (marginal models, and -s scoring) and batch. Both
take --device {cuda,cpu}, default cuda; asking for cuda where there is none
is an error, not a silent move to the CPU.
"""

from __future__ import annotations

import argparse
import sys

from coati_tpu.cli import _add_model_opts, _fill_aln, _positive_float

PROG = "coati-tpu-torch"
NOT_PORTED = ("msa", "sample", "format", "genseed", "version")


def _add_device_opt(p) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to align on (default: cuda)")


def cmd_alignpair(argv) -> int:
    p = argparse.ArgumentParser(
        prog=f"{PROG} alignpair",
        description="coati alignpair - pairwise alignment of nucleotide sequences",
    )
    _add_model_opts(p, "Substitution model (mar-mg mar-ecm)")
    p.add_argument("-r", "--ref", default="", dest="refs",
                   help="Name of reference sequence (default: 1st seq)")
    p.add_argument("-v", "--rev-ref", action="store_true", dest="rev",
                   help="Use 2nd seq as reference")
    p.add_argument("-s", "--score", action="store_true",
                   help="Score input alignment and exit")
    p.add_argument("-b", "--base-error", type=_positive_float, default=0.0001,
                   help="Base calling error rate")
    _add_device_opt(p)
    args = p.parse_args(argv)
    if args.rate and args.model != "mar-mg":
        p.error("--sub excludes --model")
    if args.refs and args.rev:
        p.error("-r excludes -v")

    aln = _fill_aln(args)
    aln.refs = args.refs
    aln.rev = args.rev
    aln.score = args.score
    if not aln.is_marginal():
        raise NotImplementedError(
            f"model {aln.model} is not yet ported to {PROG} "
            "(the triplet engine runs in coati-tpu)")
    from coati_tpu_torch.driver import marg_alignment

    return 0 if marg_alignment(aln, device=args.device) else 1


def cmd_batch(argv) -> int:
    from coati_tpu_torch.batchrun import cmd_batch as run

    return run(argv)


VERBS = {"alignpair": cmd_alignpair, "batch": cmd_batch}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(f"Usage: {PROG} command [options]\n\nCommands available:")
        for v in VERBS:
            print(f"  {v}")
        return 0 if argv else 1
    verb = argv[0]
    if verb in NOT_PORTED:
        print(f"ERROR: command {verb} is not yet ported to {PROG}; "
              f"use coati-tpu {verb}.", file=sys.stderr)
        return 1
    if verb not in VERBS:
        print(f"ERROR: command {verb} not supported.", file=sys.stderr)
        return 1
    from coati_tpu.version import check_version_number

    rc = check_version_number()
    if rc != 0:
        return rc
    try:
        return VERBS[verb](argv[1:])
    except SystemExit as exc:  # argparse validation errors (exit code 2)
        return int(exc.code) if exc.code else 0
    except (ValueError, RuntimeError, OSError) as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
