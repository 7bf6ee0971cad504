from repro_torch.optim.adamw import (AdamWConfig, TensorSpec, adamw_init,
                                     adamw_update, opt_state_axes,
                                     opt_state_specs)
from repro_torch.optim.schedule import lr_schedule
