from lct_gan_tpu_torch.metrics.sisdr import si_sdr, batch_si_sdr
from lct_gan_tpu_torch.metrics.stoi import stoi
from lct_gan_tpu_torch.metrics.fwsegsnr import fwsegsnr
from lct_gan_tpu_torch.metrics.pesq_p862 import pesq_p862
from lct_gan_tpu_torch.metrics.external import (
    pesq_score,
    pesq_estimate,
    stoi_score,
    compute_metrics_for_pair,
    pesq_available,
)

__all__ = [
    "si_sdr",
    "batch_si_sdr",
    "stoi",
    "fwsegsnr",
    "pesq_p862",
    "pesq_score",
    "pesq_estimate",
    "stoi_score",
    "compute_metrics_for_pair",
    "pesq_available",
]
