"""The paper's own matrix-completion experiment configs (Table 1/2)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class MFConfig:
    name: str
    m: int                # users (rows)
    n: int                # items (columns)
    nnz: int              # ratings
    k: int = 100          # latent dimension (Table 1)
    lam: float = 0.05
    alpha: float = 0.012  # step schedule (eq. 11)
    beta: float = 0.05


NETFLIX = MFConfig(name="netflix", m=2_649_429, n=17_770, nnz=99_072_112,
                   lam=0.05, alpha=0.012, beta=0.05)
YAHOO = MFConfig(name="yahoo-music", m=1_999_990, n=624_961,
                 nnz=252_800_275, lam=1.00, alpha=0.00075, beta=0.01)
HUGEWIKI = MFConfig(name="hugewiki", m=50_082_603, n=39_780,
                    nnz=2_736_496_604, lam=0.01, alpha=0.001, beta=0.0)


def scaled(cfg: MFConfig, factor: float) -> MFConfig:
    """Shrink a dataset config by ``factor`` (laptop-scale runs keep the
    row/column *ratio* and density of the original)."""
    import math
    s = math.sqrt(factor)
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-x{factor:g}",
        m=max(64, int(cfg.m * s)), n=max(32, int(cfg.n * s)),
        nnz=max(1000, int(cfg.nnz * factor)))
