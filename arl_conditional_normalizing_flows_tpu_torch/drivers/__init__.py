"""Command-line drivers: ``cnf-conv`` (``drivers/conv.py``), ``cnf-eval``
(``drivers/evaluate.py``), ``cnf-pretrain-noise``
(``drivers/pretrain_noise.py``) and ``cnf-toy`` (``drivers/toy.py``), run as
``python -m arl_conditional_normalizing_flows_tpu_torch.drivers.<name>``."""
