"""The benchmark's harness: the manifest, the camera walk, the hooks
around the program's passes and kernels, the reduction of the profiler's
trace, the roofline arithmetic and the comparison with the reference.

Nothing here imports the program at module level: ``run.py`` checks for
the card first, and the tests import every module on a CPU host.
"""
