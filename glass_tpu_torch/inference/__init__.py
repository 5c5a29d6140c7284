from .runner import GlassRunner
