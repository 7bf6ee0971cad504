from repro_torch.runtime.failures import FailureInjector, SimulatedHostFailure
from repro_torch.runtime.trainer import Trainer, TrainerConfig
