from repro_torch.isa.compiled import (CompiledProgram, CompileError,  # noqa: F401
                                      Trace, compile_program)
from repro_torch.isa.isa import OPCODES, REGS, Instruction  # noqa: F401
