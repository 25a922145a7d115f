"""Plain PyTorch references, independent of the port: they import nothing
of ``sparkucx_tpu_torch`` and take nothing the port made. Float32 matrix
products run with TF32 off (:func:`precision.strict_float32`); the same
code with ``tf32=True`` is the lower-precision control."""
