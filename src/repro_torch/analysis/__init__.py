"""Protocol verifier for the coroutine runtime and cache hierarchy.

Two layers (docs/verification.md describes the same two for the JAX
package; this package keeps its own copy):

  * static lint (``repro_torch.analysis.lint``): AST passes over the source —
    op-registry/arity checks against ``registry.ENGINE_OPS``, LOCKED-window
    begin/finish/abort pairing, coroutine purity, determinism lints (the
    path-scoped ones over ``repro_torch/core``, including torch's global
    generator).  Never imports the code under check; runs as
    ``python -m repro_torch.analysis``.
  * dynamic checker (``repro_torch.analysis.protocol``): a trace validator
    armed by ``SystemConfig.verify_protocol`` that validates live pool/HBM
    slot transitions against the declarative spec
    (``repro_torch.analysis.spec``), plus the bounded schedule explorer
    (``repro_torch.analysis.explore``) that permutes the engine's
    scheduling ties and proves results schedule-invariant.  The slot arrays
    it reads are NumPy on the host, so it runs beside a search on the card
    without touching a device tensor.
"""

from repro_torch.analysis.lint import Finding, run_lint, run_lint_text  # noqa: F401
