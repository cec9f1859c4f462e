"""SplatFields in PyTorch for NVIDIA Hopper GPUs.

A port of ``splatfields_tpu`` (JAX + Pallas), which stays in the repository
as the reference each module is tested against. Module paths and names
mirror the JAX package so every counterpart is easy to find. This package
imports torch, numpy, scipy and the standard library, never JAX, flax or
``splatfields_tpu``, nor PIL, cv2, imageio, sklearn or msgpack (yaml only
for ``--configs``): its PNG codec, k-means and msgpack are its own.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
there is no silent CPU fallback.
"""
