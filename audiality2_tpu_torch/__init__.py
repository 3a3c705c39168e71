"""audiality2_tpu_torch: the PyTorch/CUDA port of audiality2_tpu's
device render path.

The control plane (A2S compiler, engine state, objects, units and the
native C++ runtime bindings) is a verbatim copy of the JAX package's
JAX-free modules, kept byte-identical so drift shows in the tests.
What the JAX package runs on the TPU runs here in PyTorch, with the
wavetable oscillator as a hand-written CUDA kernel
(``cuda/csrc/osc_kernel.cu``).  Nothing here imports ``jax`` or
``audiality2_tpu``.
"""

from .engine.state import open_engine, Config, State, Interface
from .errors import A2Error, A2Exception, A2CompileError
from .constants import WaveType, SampleFormat

__version__ = "0.1.0"
