"""raster_roofline.serve (%): the rasterizer's least time over the device
time of its kernels in the traced stretch. The least time is the larger of
the bytes it must move over the card's 3.35 TB/s (each render's mesh and
camera read once, its image of 7 float32 channels written once) and
FLOP_PER_TEST flops a pixel test over 67 TFLOP/s, where a render's pixel
tests are, over its faces, the pixels inside the image that the face's
screen box +-1 px reaches, counted by the reference's geometry from the
meshes and the poses and crop cameras of the stretch's renders."""

from benchmark import readers

SOURCE = "device_trace"
LAYER = "ops: rasterizer_fused + csrc/raster_fused.cu (the hand-written kernel)"
MOVES = "poses_per_s"
WORKLOADS = ["megapose-bop"]
KERNELS = ("bin_kernel", "order_kernel", "raster_kernel")
FLOP_PER_TEST = 30  # edge functions, 1/z and its clamp, the compare: an assumption


def read(run):
    return readers.raster_roofline(run, KERNELS, FLOP_PER_TEST)
