"""Utilities: the viewer socket and logging (counterpart of
f3d_gaus_tpu/utils/)."""
