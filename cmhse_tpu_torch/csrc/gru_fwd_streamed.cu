// The streamed-W_h instantiations of gru_fwd.cu's kernel (past
// cmhse_gru_fwd_max_hidden), in a translation unit of their own: the build
// starts one nvcc a source, so these compile beside the resident ones
// instead of after them. gru_fwd.cu's cmhse_gru_fwd calls gru_fwd_streamed.

#define GRU_FWD_STREAMED_UNIT
#include "gru_fwd.cu"
