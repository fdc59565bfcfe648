from .errors import FaspError, chkerr
from .messages import (amg_complexity, cputime, gettime, itinfo, message,
                       set_output, timed, warn)
from .params import (AMGParam, ILUParam, ITSParam, InputParam, SWZParam,
                     apply_cli_overrides, param_init, parse_ini)
from .checkpoint import (load_hierarchy, load_iterate, load_pytree,
                         save_hierarchy, save_iterate, save_pytree)
from .graphics import grid2d_plot, spy_plot, spy_subplot, write_bmp16

__all__ = [
    "FaspError", "chkerr",
    "amg_complexity", "cputime", "gettime", "itinfo", "message",
    "set_output", "timed", "warn",
    "AMGParam", "ILUParam", "ITSParam", "InputParam", "SWZParam",
    "apply_cli_overrides", "param_init", "parse_ini",
    "load_hierarchy", "load_iterate", "load_pytree",
    "save_hierarchy", "save_iterate", "save_pytree",
    "grid2d_plot", "spy_plot", "spy_subplot", "write_bmp16",
]
