"""The benchmark's plain reference: frozen copies of the port's plain
paths (``rvgrt_tpu_torch``'s world build, tracer, shading, GI update,
composite, expand, temporal accumulator, scheduler and camera, with the
plain versions of its kernels in ``plain_ops.py``), trimmed to what the
benchmark's frames reach, plus ``frame.py``, which strings them together.

They import nothing of the port, of JAX or of the JAX package: a later
change to the port cannot change what the port is held against.  Their
docstrings are the port's at the time of the copy, and speak of the port.
"""
