"""Model zoo of the port; importing a family registers it."""

from se_tpu_torch.models import crn  # noqa: F401  (registers "crn")
from se_tpu_torch.models import ctsnet  # noqa: F401  (registers "ctsnet")
from se_tpu_torch.models import dccrn  # noqa: F401  (registers "dccrn")
from se_tpu_torch.models import deepxi  # noqa: F401  (registers "deepxi")
from se_tpu_torch.models import dpcrn  # noqa: F401  (registers "dpcrn")
from se_tpu_torch.models import fullsubnet  # noqa: F401  (registers "fullsubnet")
from se_tpu_torch.models import g2net  # noqa: F401  (registers "g2net")
from se_tpu_torch.models import gcrn  # noqa: F401  (registers "gcrn")
from se_tpu_torch.models import lstm  # noqa: F401  (registers "lstm")
from se_tpu_torch.models import taylorsenet  # noqa: F401  (registers "taylorsenet")
from se_tpu_torch.models import uformer  # noqa: F401  (registers "uformer")
from se_tpu_torch.models.registry import available_models, get_model

__all__ = ["available_models", "get_model"]
