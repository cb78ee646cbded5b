"""pertrenderer_tpu_torch — the PyTorch / CUDA port of pertrenderer_tpu.

Differentiable rendering with perturbed optimizers, ported from the JAX
package ``pertrenderer_tpu`` (the reference it is held against) to PyTorch
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).  The port covers
the flat fused forward render: ``MeshRenderer(meshes, seeds=...)`` on scenes
whose faces all fit a slot (F <= faces_per_pixel), through kernel K3, with
the hash PRNG pinned by kernel K1.  On CPU tensors every kernel runs as its
plain PyTorch version.

Everything is float32.  TF32 is turned off here, at import: a TF32 matmul
keeps ~3 decimal digits, which moves projected vertices by more than a
sigma = 1e-3 blur band (the bug class of the TPU's bf16 MXU pass).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from pertrenderer_tpu_torch.blending import BlendParams  # noqa: E402
from pertrenderer_tpu_torch.cameras import (  # noqa: E402
    OpenGLPerspectiveCameras,
    PerspectiveCameras,
    look_at_rotation,
    look_at_view_transform,
)
from pertrenderer_tpu_torch.io import load_cube  # noqa: E402
from pertrenderer_tpu_torch.lights import (  # noqa: E402
    DirectionalLights,
    Materials,
    PointLights,
)
from pertrenderer_tpu_torch.models.renderer import (  # noqa: E402
    MeshRasterizer,
    MeshRenderer,
)
from pertrenderer_tpu_torch.models.shaders import (  # noqa: E402
    RandomPhongShader,
    RandomSimpleShader,
)
from pertrenderer_tpu_torch.models.smoothagg import (  # noqa: E402
    CauchyAgg,
    GaussianAgg,
    GaussianAgg_wovr,
    HardAgg,
    SoftAgg,
)
from pertrenderer_tpu_torch.models.smoothrast import (  # noqa: E402
    AffineRast,
    ArctanRast,
    GaussianRast,
    GaussianRast_wovr,
    HardRast,
    SoftRast,
)
from pertrenderer_tpu_torch.ops.fused_render import (  # noqa: E402
    RenderPlan,
    render_plan,
)
from pertrenderer_tpu_torch.ops.perturbed import (  # noqa: E402
    log_corrected,
    prod_corrected,
)
from pertrenderer_tpu_torch.ops.rasterize import (  # noqa: E402
    RasterizationSettings,
)
from pertrenderer_tpu_torch.structures import Meshes  # noqa: E402
from pertrenderer_tpu_torch.textures import (  # noqa: E402
    TexturesAtlas,
    TexturesUV,
    TexturesVertex,
)
from pertrenderer_tpu_torch.transforms import (  # noqa: E402
    Rotate,
    so3_exp_map,
    so3_exponential_map,
    so3_log_map,
    so3_relative_angle,
)

__version__ = "0.1.0"
