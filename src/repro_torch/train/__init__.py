from repro_torch.train.step import build_train_step, train_state_specs
