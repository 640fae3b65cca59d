"""The upstream project's five release entries (its ``hubconf.py``), as port
models: ``hub.resnet18_fbaug_highreg(pretrained=True, file="final_fbaug_highreg_lr08_resnet18.pth")``.

``pretrained=False`` (the default, as upstream) gives the seeded initial
weights; ``pretrained=True`` loads the entry's release asset
(:data:`~.pretrained.RELEASE_FILES`) from the local ``file=``, and without
one raises: nothing is downloaded. ``channels`` and ``classes`` pass on to
:func:`~.pretrained.load_pretrained`.
"""

from .pretrained import RELEASE_FILES, load_pretrained

__all__ = ["RELEASE_FILES", *RELEASE_FILES]


def resnet18_fbaug_clip(pretrained=False, file=None, **kwargs):
    return load_pretrained("resnet18_fbaug_clip", file=file, pretrained=pretrained, **kwargs)


def resnet18_fbaug_gradreg(pretrained=False, file=None, **kwargs):
    return load_pretrained("resnet18_fbaug_gradreg", file=file, pretrained=pretrained, **kwargs)


def resnet18_fbaug_gradreg_v2(pretrained=False, file=None, **kwargs):
    return load_pretrained("resnet18_fbaug_gradreg_v2", file=file, pretrained=pretrained,
                           **kwargs)


def resnet18_fbaug_highreg(pretrained=False, file=None, **kwargs):
    return load_pretrained("resnet18_fbaug_highreg", file=file, pretrained=pretrained, **kwargs)


def resnet152_fbaug_highreg(pretrained=False, file=None, **kwargs):
    return load_pretrained("resnet152_fbaug_highreg", file=file, pretrained=pretrained, **kwargs)
