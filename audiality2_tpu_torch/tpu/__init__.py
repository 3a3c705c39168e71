"""Host-engine hooks of the port: the modules that the copied
``engine/core.py`` imports as ``..tpu.row_kernel``, ``..tpu.kernels``
and ``..tpu.osc_kernel`` (the batched record / replay engine's row
batch, its wave atlas and the device pair atlas), and the oscillator's
general entry point (``osc_kernel.OscBatch``, ``evaluate_osc_batch``)."""
