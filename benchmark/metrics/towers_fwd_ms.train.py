"""Device milliseconds of the VGG16 and CLIP towers' forwards per training
step (the program's spans `vgg` and `clip` under the root `step`, CUDA
events at their ends) in the traced step."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["vgg", "clip"], "step")
