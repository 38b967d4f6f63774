from tpurt_torch.io.exr import read_exr, write_exr
from tpurt_torch.io.image import read_image, write_image
