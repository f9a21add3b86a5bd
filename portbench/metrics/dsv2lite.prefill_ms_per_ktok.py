"""Model step: device milliseconds of the window's prefill calls (full and
suffix) by CUDA events, per 1,000 prompt tokens they ran, in
``dsv2lite.longdoc``: ``prefill.device_ms_per_ktok``'s reading."""

from portbench import manifest

read = manifest.reader("prefill.device_ms_per_ktok")
