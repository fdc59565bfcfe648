from .errors import FaspError, chkerr
from .messages import (amg_complexity, cputime, gettime, itinfo, message,
                       set_output, timed, warn)
from .params import (AMGParam, ILUParam, ITSParam, InputParam, SWZParam,
                     apply_cli_overrides, param_init, parse_ini)
from .graphics import grid2d_plot, spy_plot, spy_subplot, write_bmp16

__all__ = [
    "FaspError", "chkerr",
    "amg_complexity", "cputime", "gettime", "itinfo", "message",
    "set_output", "timed", "warn",
    "AMGParam", "ILUParam", "ITSParam", "InputParam", "SWZParam",
    "apply_cli_overrides", "param_init", "parse_ini",
    "grid2d_plot", "spy_plot", "spy_subplot", "write_bmp16",
]
