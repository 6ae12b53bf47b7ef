"""CsrMV benchmark CLI of the port — flag-compatible with spmv_cli.py.

Usage (mirrors cpu_spmv.cpp:686-706 / gpu_spmv.cu:676-696):

    python -m merge_spmv_tpu_torch.cli --mtx=<matrix market file> [options]
    python -m merge_spmv_tpu_torch.cli --grid2d=<width> | --grid3d=<width> |
                       --wheel=<spokes> | --dense=<cols> |
                       --powerlaw=<n> | --uniform=<n>

Options:
    --fp32 (default) | --fp64        value dtype
    --alpha=<s> / --beta=<s>         y = alpha*A*x + beta*y_in
                                     (defaults 1.0 / 0.0; y_in = ones)
    --i=<timing iterations>          default: adaptive 16G-nnz rule
    --quiet                          CSV output for corpus sweeps
    --v / --v2                       verbose / dump matrix
    --backends=merge,dia,split,hotcold,xla,scipy,torch
                                     comma list (default scipy,xla,merge):
                                     merge = the merge-path CUDA kernels,
                                     dia = the diagonal split (DIA kernel +
                                     merge kernels for the leftover),
                                     split = the banded stack (one merge
                                     launch + reshape-sum), hotcold = the
                                     hot/cold column split (two merge
                                     launches), xla = cuSPARSE (the device
                                     library baseline), scipy / torch =
                                     host baselines
    --tile-items=<n>                 merge items per thread block (a
                                     multiple of 1024 for split)
    --autotune                       merge: the autotuner's tile size
    --gather-group=<n>, --gather-cluster
                                     the TPU package's tuning knobs:
                                     accepted and ignored
    --split=<n>                      quantile band count for the split
                                     backend (default: geometric (8, 32)
                                     edges)
    --seed=<n>                       generator seed
    --cpu                            run the kernels' plain versions on the
                                     CPU (default: the card; raises without
                                     one)
"""

import sys

__all__ = ["parse_args", "main"]


def parse_args(argv):
    """--key=value / --flag parsing (utils.h:280-445 semantics); ``--cpu``
    becomes ``device="cpu"``."""
    args = {}
    for a in argv[1:]:
        if not a.startswith("--"):
            print(f"unrecognized argument: {a}", file=sys.stderr)
            sys.exit(2)
        body = a[2:]
        if "=" in body:
            k, v = body.split("=", 1)
            k = k.replace("-", "_")
            if k in ("mtx", "backends"):
                args[k] = v
            elif k in ("alpha", "beta"):
                args[k] = float(v)
            else:
                args[k] = int(v)
        else:
            args[body.replace("-", "_")] = True
    if "backends" in args:
        args["backends"] = args["backends"].split(",")
    if args.get("fp64"):
        args["fp32"] = False
    else:
        args.setdefault("fp32", True)
    if "i" in args and isinstance(args["i"], bool):
        del args["i"]
    if args.pop("cpu", False):
        args["device"] = "cpu"
    return args


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    args = parse_args(argv)
    if args.get("help"):
        print(__doc__)
        return 0
    from merge_spmv_tpu_torch.bench.driver import run_benchmark
    run_benchmark(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
