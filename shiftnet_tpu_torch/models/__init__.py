"""GShiftNet models of the port (counterpart of ``shiftnet_tpu.models``)."""
from shiftnet_tpu_torch.models.config import CONFIGS, GShiftNetConfig
from shiftnet_tpu_torch.models.gshift import (Encoder2, GShiftNet,
                                              build_model, init_params,
                                              init_state)

__all__ = ['CONFIGS', 'Encoder2', 'GShiftNet', 'GShiftNetConfig',
           'build_model', 'init_params', 'init_state']
