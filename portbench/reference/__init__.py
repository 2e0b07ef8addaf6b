"""The plain reference that decides ``correct``: the published model, its
frontend, the crossfade stitch and the eventizer, in plain PyTorch and NumPy.

Nothing here imports the port or JAX, and nothing takes a table the port
made: the benchmark hands the same weights and audio to both sides, and the
reference works out its own filter, windows and rotary tables.
"""
