"""The repo's tools on the port: each runs as
`python -m mwr_fast_forward_operators_and_lbls_tpu_torch.tools.<name>`.

  campaign_demo  the campaign chain from a synthetic 3-campaign raw archive
                 (preprocess -> fit -> forward -> analysis -> full report)
  perf_probe     the headline forward split into K1, K2 and the glue
  make_golden    the float64 accuracy anchors, after the literature gate
  fit_tables     retune factors of the line tables against a golden file

Each computes on the CUDA card unless `--device cpu` asks for the CPU, and
raises before any work where there is no card.  They import torch, numpy
and the port only; what they share with the JAX package's `tools/` is
copied (`tests/test_torch_tools.py` holds the copies equal).
"""
