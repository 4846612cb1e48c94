"""``repro_torch`` — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors ``repro``'s module layout and names: the timer infrastructure
(``core``, ``timing``) and the adaptation loop (``adapt``) are its own copies,
the model code is plain PyTorch on tensors with an explicit ``device``, and
where ``repro`` runs a Pallas TPU kernel this package runs a kernel written by
hand in CUDA C++ for ``sm_90a`` (``kernels/csrc``).  It imports neither JAX
nor ``repro``.  It carries every model family's serving and training paths,
the 1F1B pipeline, checkpointing, the monitor, and the soak and fleet
harnesses (``soak``, ``fleet``, ``faults.soak``).
"""
