"""Control loops over the informer/workqueue substrate (reference:
pkg/controller, registered via controllermanager.go:515): the base
worker pattern and the two controllers whose admission plugins the
API front's default chain installs — the ServiceAccount defaulter and
the ResourceQuota validator.  Copies of the reference package's
controllers/base.py, serviceaccount.py and resourcequota.py."""

from .base import Controller
from .resourcequota import ResourceQuotaController
from .serviceaccount import ServiceAccountController

__all__ = [
    "Controller",
    "ResourceQuotaController",
    "ServiceAccountController",
]
