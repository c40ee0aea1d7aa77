"""The host-side native library of the port: the C++ wav decoder
(`wav_io.cc`, built with g++ at first use) and its ctypes binding."""

from lct_gan_tpu_torch.ops.native.wav_loader import (build_library,
                                                     load_mono_wave_native)

__all__ = ["build_library", "load_mono_wave_native"]
