"""Hand-written Hopper kernels for the dataframe hot paths.

``csrc/*.cu`` hold the CUDA C++ sources (built at first use by
``_build``); ``filter_compact``, ``groupby_sum`` and ``zonemap`` are their
ctypes wrappers, each with a launch counter; ``ref`` holds the plain
PyTorch versions; ``ops`` dispatches between the two by tensor device.
"""
