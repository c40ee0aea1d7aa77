from lct_gan_tpu_torch.eval.compare import (ModelComparator,
                                            make_deepfilternet_system,
                                            make_torch_reference_system,
                                            make_torch_system, plot_spec,
                                            plot_specs_stack,
                                            plot_specs_triptych)
from lct_gan_tpu_torch.eval.serve import make_enhance
from lct_gan_tpu_torch.eval.streaming import (StreamingEnhancer,
                                              enhance_in_chunks)

__all__ = ["make_enhance", "StreamingEnhancer", "enhance_in_chunks",
           "ModelComparator", "make_deepfilternet_system",
           "make_torch_reference_system", "make_torch_system", "plot_spec",
           "plot_specs_stack", "plot_specs_triptych"]
