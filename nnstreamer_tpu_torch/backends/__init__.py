"""Filter backends: the vtable (``base``) and the torch execution backend."""
