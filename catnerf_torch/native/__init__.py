"""The C++ geometry library (a copy of the JAX package's `native/`)."""
