"""Guard-rail warning decorators for Material misuse (port of
fireflies_tpu/utils/warnings.py): a material has no pose, so rotating,
translating, re-parenting or placing it has no effect on shading."""

from __future__ import annotations

import functools
import warnings


def _warn_decorator(message: str):
    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(message, stacklevel=2)
            return func(*args, **kwargs)

        return wrapper

    return decorator


def rotation_assignment_warning(func):
    return _warn_decorator(
        "Assigning a rotation to a Material has no effect on shading; "
        "did you mean to rotate the mesh?"
    )(func)


def relative_assignment_warning(func):
    return _warn_decorator(
        "Parent-child relations on a Material are ignored during rendering."
    )(func)


def translation_assignment_warning(func):
    return _warn_decorator(
        "Assigning a translation to a Material has no effect on shading."
    )(func)


def world_assignment_warning(func):
    return _warn_decorator(
        "Assigning a world transform to a Material has no effect on shading."
    )(func)


# The reference's CamelCase names.
RotationAssignmentWarning = rotation_assignment_warning
RelativeAssignmentWarning = relative_assignment_warning
TranslationAssignmentWarning = translation_assignment_warning
WorldAssignmentWarning = world_assignment_warning
