"""The plain reference of the ocean step: a frozen copy of the port's
`core/` on its per-call path, in plain PyTorch, importing nothing of the
port, so that a change to the port cannot change what it is held to."""
