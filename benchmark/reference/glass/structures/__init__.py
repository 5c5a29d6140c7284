from .instances import Instances
