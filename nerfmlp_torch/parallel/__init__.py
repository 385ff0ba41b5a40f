"""Training steps (counterpart of ``nerfmlp_tpu/parallel``); one device."""
