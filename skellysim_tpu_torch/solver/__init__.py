from .gmres import GmresResult, gmres, gmres_ir

__all__ = ["GmresResult", "gmres", "gmres_ir"]
