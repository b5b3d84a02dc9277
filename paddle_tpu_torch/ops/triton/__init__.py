"""Kernels written in Triton.  ``triton`` is imported only inside the
function that launches a kernel, so this package imports without it."""
