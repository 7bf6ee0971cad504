from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore, save)
