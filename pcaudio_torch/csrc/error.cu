// The text of a CUDA error code that an entry point returned: compiled into
// every library whose launches raise through _build.launch_in.
#include <cuda_runtime.h>

extern "C" const char* pcaudio_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
