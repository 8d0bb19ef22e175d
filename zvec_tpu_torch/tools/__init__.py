"""CLI tools mirroring the reference's `tools/core` harness, copied from
`zvec_tpu/tools/` and pointed at this package:

  python -m zvec_tpu_torch.tools.build    — offline collection build from .npy/.vecs
  python -m zvec_tpu_torch.tools.recall   — recall@{1,10,50,100} vs ground truth
  python -m zvec_tpu_torch.tools.bench    — QPS + latency percentiles
  python -m zvec_tpu_torch.tools.txt2vecs — text vector records -> .fvecs / .npz

Collections they write open in `zvec_tpu` as well, and the other way round.
"""
