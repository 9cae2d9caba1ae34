"""See the package docstring in vec_vad_torch/__init__.py."""
