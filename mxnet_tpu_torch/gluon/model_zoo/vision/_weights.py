"""The refusal every zoo family gives ``pretrained=True``."""
from ....base import MXNetError


def refuse_pretrained(pretrained, model):
    """Raise for ``pretrained=True``: the published weights of ``model``
    are not in the repository, and random weights must not come back
    in their place."""
    if pretrained:
        raise MXNetError(
            "%s: pretrained=True needs the published weights, which are "
            "not in this repository; pass a local .params file to "
            "load_parameters instead." % model)
