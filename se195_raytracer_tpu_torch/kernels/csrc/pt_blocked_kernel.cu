// K2's build: csrc/pt_kernel.cu with PT_K2_ROUNDED set, so that K2 rounds
// every product and sum of its sphere test and of a path's geometry on its
// own, as its plain version's separate tensor ops round them (why: the
// comment at PT_K2_ROUNDED in pt_kernel.cu). kernels/pt_kernel.py loads
// K2's entry, pt_blocked_pass_cuda, from this library and K1's from
// pt_kernel's, whose K2 entry has K1's arithmetic.
#define PT_K2_ROUNDED 1
#include "pt_kernel.cu"
