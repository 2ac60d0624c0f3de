"""``nn.Module`` cascade of the port, in the reference state_dict schema."""

from mdfnet_tpu_torch.models.core import CoreNet
from mdfnet_tpu_torch.models.registry import build_model, count_params
