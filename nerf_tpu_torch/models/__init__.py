"""The port's networks as ``nn.Module``s with the reference's torch layout."""

from nerf_tpu_torch.models.proposal import ProposalNetwork
from nerf_tpu_torch.models.refnerf import RefNeRF
from nerf_tpu_torch.models.vanilla import VanillaNeRF

__all__ = ["ProposalNetwork", "RefNeRF", "VanillaNeRF"]
