from repro_torch.serve.step import build_decode_step, build_prefill_step
