"""Utilities: device timing, the kernels' build directory
(``--compile_cache``), profiler traces (``--profile_dir``)."""
