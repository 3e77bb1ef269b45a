"""Designs of the port's kernels that were measured and not taken, with the
scripts that time them beside the kernels in csrc/ on a CUDA device. The
codec imports nothing from here."""
