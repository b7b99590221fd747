"""The chained model-update step and the (patch, frame) mesh of
``torch.distributed`` ranks it runs on (port of ``cnmf_e_tpu/parallel``)."""
