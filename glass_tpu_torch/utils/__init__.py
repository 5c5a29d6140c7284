from .common import rgb2grey
