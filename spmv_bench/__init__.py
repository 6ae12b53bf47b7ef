"""The benchmark of merge_spmv_tpu_torch on one NVIDIA H100.

    python3 spmv_bench/run.py --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

Every piece of a cell is found by name (see run.py): a configuration in
``configs/<config>.json`` whose ``generator`` names ``generators/<g>.py``,
a traffic mix in ``traffic/<mix>.json`` whose ``loop`` names
``loops/<loop>.py``, the limits of the comparison in
``limits/<cell>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``, or in ``metrics/<quantity>.py`` for every
cell's ``<quantity>.<mix>``.  ``roofline.py`` holds the byte models and the
card's published peaks, ``reference.py`` the plain PyTorch reference and
the comparison, ``trace.py`` the reduction of a profiler trace.  Only
``system.py`` imports the package under test.
"""
