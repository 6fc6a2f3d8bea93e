r"""Keyword-argument aliasing (counterpart of :mod:`mrphy_tpu._kwalias`).

Primary names are ASCII; the reference API's Unicode keyword spellings
(``γ``, ``Δf``, ``γ2πdt``) are accepted as aliases.
"""

import functools

__all__ = ['kwalias']


def kwalias(**alias_to_primary):
    r"""Decorator: accept alias keyword names, mapping them to primary names.

    Usage::

        @kwalias(**{'γ': 'gam', 'Δf': 'df'})
        def f(x, *, gam=None, df=None): ...

        f(x, γ=4257.6)   # same as f(x, gam=4257.6)
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            for alias, primary in alias_to_primary.items():
                if alias in kwargs:
                    if primary in kwargs:
                        raise TypeError(
                            f"{fn.__name__}() got both '{alias}' and its "
                            f"primary spelling '{primary}'")
                    kwargs[primary] = kwargs.pop(alias)
            return fn(*args, **kwargs)
        wrapper.__kwaliases__ = dict(alias_to_primary)
        return wrapper
    return deco
