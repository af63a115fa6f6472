from .gmres import (BatchedGmresResult, GmresResult, gmres, gmres_batched,
                    gmres_ir, gmres_ir_batched)

__all__ = ["BatchedGmresResult", "GmresResult", "gmres", "gmres_batched",
           "gmres_ir", "gmres_ir_batched"]
