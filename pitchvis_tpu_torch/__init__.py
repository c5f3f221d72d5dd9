"""pitchvis_tpu_torch: the PyTorch/CUDA port of pitchvis_tpu.

The streaming hop (ring + AGC -> fused VQT -> analysis) runs on an NVIDIA
H100 through three hand-written CUDA kernels (csrc/: VQT, peak primitives,
AGC), each with a plain PyTorch version that runs for CPU tensors. The
rasterizer (models/render.py: ``render_streams``, ``render_batch``,
``render_frame``) turns the viewer's outputs into uint8 sRGB frames, its
back-to-front patch composite a fourth kernel (csrc/composite.cu). The
stages after the analysis, the ML inference (models/pitch_mlp.py,
models/ml_system.py), the LED color block (io/led.py) and the viewer's
display outputs (models/viewer.py), are plain PyTorch, as is the model's
trainer (train/train.py). The
serving runtime (``StreamServer``, ``ServeLoop``; runtime/) feeds the same
VQT, analysis and output stages from a native ingest ring bank with AGC in
C++ on the host (native/, built with g++ at first use). Entry points run on the card unless
given ``device="cpu"``. The command line, ``python -m pitchvis_tpu_torch.demo``
(demo.py), puts a WAV file, a test tone, a pipe or an ALSA microphone
through these paths (host I/O under io/, the resampler in ops/resample.py).
Several devices serve one batch of streams split by rows (parallel/:
``StreamServer(mesh=)``, ``make_sharded_pipeline_step``, the sharded render;
runtime/multihost_serve.py with one process a host); as in the JAX package,
nothing of it is exported here. The package imports nothing of the JAX
package; the modules it needs from there are copied.
"""

from .core.config import (
    AgcParameters,
    AnalysisParameters,
    ColorParameters,
    PeakDetectionParameters,
    VqtParameters,
    VqtRange,
)
from .core.errors import AboveNyquistError, VqtError, WindowExceedsNFftError
from .kernel.builder import VqtKernel, build_kernel, get_kernel, kernel_stats
from .models.analysis import (
    AnalysisOutputs,
    AnalysisState,
    analysis_step,
    analysis_step_batch,
    init_state_batch,
)
from .models.ml_system import MlState, init_ml_state_batch, ml_step_batch
from .models.pitch_mlp import PitchMLP
from .models.pipeline import (
    PipelineOutputs,
    PipelineState,
    StreamingPipeline,
    init_pipeline_state,
    pipeline_step,
    pipeline_step_multi,
)
from .models.render import DebugInputs, RenderConfig, make_scene, render_batch, render_frame, render_streams
from .ops.vqt import (
    Vqt,
    VqtArrays,
    make_vqt_arrays,
    power_to_db,
    vqt_db_auto,
    vqt_db_batch,
    vqt_power_batch,
)
from .ops.vqt_pallas import PallasVqtArrays, vqt_db_pallas, vqt_power_pallas
from .runtime.loop import ServeLoop
from .runtime.server import CompactOutputs, ServeOutputs, StreamServer

__all__ = [
    "AgcParameters",
    "AnalysisParameters",
    "ColorParameters",
    "PeakDetectionParameters",
    "VqtParameters",
    "VqtRange",
    "VqtError",
    "AboveNyquistError",
    "WindowExceedsNFftError",
    "VqtKernel",
    "build_kernel",
    "get_kernel",
    "kernel_stats",
    "AnalysisOutputs",
    "AnalysisState",
    "analysis_step",
    "analysis_step_batch",
    "init_state_batch",
    "MlState",
    "init_ml_state_batch",
    "ml_step_batch",
    "PitchMLP",
    "DebugInputs",
    "RenderConfig",
    "make_scene",
    "render_batch",
    "render_frame",
    "render_streams",
    "PipelineOutputs",
    "PipelineState",
    "StreamingPipeline",
    "init_pipeline_state",
    "pipeline_step",
    "pipeline_step_multi",
    "Vqt",
    "VqtArrays",
    "make_vqt_arrays",
    "power_to_db",
    "vqt_db_auto",
    "vqt_db_batch",
    "vqt_power_batch",
    "PallasVqtArrays",
    "vqt_db_pallas",
    "vqt_power_pallas",
    "ServeLoop",
    "StreamServer",
    "ServeOutputs",
    "CompactOutputs",
]
