"""Model zoo of the port; importing a family registers it."""

from se_tpu_torch.models import fullsubnet  # noqa: F401  (registers "fullsubnet")
from se_tpu_torch.models import uformer  # noqa: F401  (registers "uformer")
from se_tpu_torch.models.registry import available_models, get_model

__all__ = ["available_models", "get_model"]
